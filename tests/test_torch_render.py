"""The torch package's renderer (``utils/render.py``) and its CLI users
against the JAX package's (``utils/render.py``, ``cli.py``'s ``render``
and ``run --render/--live/--live-term``).

Bars: images byte-equal to JAX's on the same state, and the PNG and GIF
files byte-equal.  Two states: the splash scene (dense, most pixels
saturate) and a uniform cloud drawn at gain 1, where a pixel holds a few
particles and a particle moved across a pixel edge changes the image (the
perspective view's dot products must round as XLA:CPU's fused form, or a
few dozen of its pixels differ).
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothed_particle_hydrodynamics_tpu import cli as jcli
from smoothed_particle_hydrodynamics_tpu.config import SphConfig as JCfg
from smoothed_particle_hydrodynamics_tpu.state import ParticleState as JState
from smoothed_particle_hydrodynamics_tpu.utils import render as jr
from smoothed_particle_hydrodynamics_tpu_torch.__main__ import main
from smoothed_particle_hydrodynamics_tpu_torch.config import SphConfig as TCfg
from smoothed_particle_hydrodynamics_tpu_torch.init import load_state
from smoothed_particle_hydrodynamics_tpu_torch.models import make_scene
from smoothed_particle_hydrodynamics_tpu_torch.ops import lazy as tlazy
from smoothed_particle_hydrodynamics_tpu_torch.state import (ParticleState,
                                                             state_to_numpy)
from smoothed_particle_hydrodynamics_tpu_torch.utils import io as tio
from smoothed_particle_hydrodynamics_tpu_torch.utils import render as tr

torch.set_num_threads(1)

CAMERAS = [dict(), dict(azimuth=135.0, elevation=0.6, distance=1.8),
           dict(azimuth=30.0, elevation=-0.2, distance=1.2)]


def _jax(cfg: TCfg, st: ParticleState):
    d = state_to_numpy(st)
    return (JCfg(**dataclasses.asdict(cfg)),
            JState.from_arrays(jnp.asarray(d["position"]),
                               jnp.asarray(d["velocity"]),
                               mass=jnp.asarray(d["mass"])))


@pytest.fixture(scope="module", params=["splash", "cloud"])
def scene(request):
    if request.param == "splash":
        cfg, st = make_scene("splash", device="cpu", num_particles=300_000)
        gain = 40.0
    else:
        n = 1_000_000
        cfg = TCfg(num_particles=n)
        rng = np.random.default_rng(1)
        pos = torch.from_numpy((rng.random((n, 3)) * 6.4).astype(np.float32))
        st = ParticleState.from_arrays(pos, torch.zeros(n, 3), cfg=cfg)
        gain = 1.0
    return cfg, st, *_jax(cfg, st), gain


def _eq(a: np.ndarray, b: np.ndarray) -> None:
    assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
    assert int((a != b).sum()) == 0
    assert a.any()


@pytest.mark.parametrize("voxels", [False, True])
def test_render_frame_matches_jax(scene, voxels):
    cfg, st, jc, js, gain = scene
    _eq(tr.render_frame(cfg, st, gain=gain, voxels=voxels),
        jr.render_frame(jc, js, gain=gain, voxels=voxels))


@pytest.mark.parametrize("box", [True, False])
@pytest.mark.parametrize("cam", range(len(CAMERAS)))
def test_render_frame_perspective_matches_jax(scene, cam, box):
    cfg, st, jc, js, gain = scene
    _eq(tr.render_frame_perspective(cfg, st, gain=gain, box=box,
                                    **CAMERAS[cam]),
        jr.render_frame_perspective(jc, js, gain=gain, box=box,
                                    **CAMERAS[cam]))


def test_render_does_not_depend_on_particle_order(scene):
    """The count image is a sum: any permutation of the particles (a lazy
    run's sorted carry) draws the same bytes."""
    cfg, st, *_ = scene
    perm = torch.randperm(st.n, generator=torch.Generator().manual_seed(0))
    shuffled = st._replace(position=st.position[perm])
    for kw in (dict(voxels=True), dict()):
        assert np.array_equal(tr.render_frame(cfg, shuffled, **kw),
                              tr.render_frame(cfg, st, **kw))
    assert np.array_equal(tr.render_frame_perspective(cfg, shuffled),
                          tr.render_frame_perspective(cfg, st))


def test_ansi_frame_matches_jax(scene):
    cfg, st, jc, js, _ = scene
    grey, rgb = (tr.render_frame(cfg, st, size=256, voxels=v)
                 for v in (False, True))
    for img in (grey, rgb):
        for cols, rows in ((80, 24), (160, 60), (33, 7)):
            assert tr.ansi_frame(img, cols, rows) == jr.ansi_frame(
                img, cols, rows)


def test_png_and_gif_bytes_match_jax(scene, tmp_path, monkeypatch):
    cfg, st, *_ = scene
    grey = tr.render_frame(cfg, st)
    rgb = tr.render_frame(cfg, st, voxels=True)
    frames = [grey, tr.render_frame(cfg, st, size=512, gain=10.0), grey]
    for mod, tag in ((tr, "t"), (jr, "j")):
        mod.save_png(grey, str(tmp_path / f"{tag}_grey.png"))
        mod.save_png(rgb, str(tmp_path / f"{tag}_rgb.png"))
        mod.save_gif(frames, str(tmp_path / f"{tag}.gif"))
        mod._write_png_gray(grey, str(tmp_path / f"{tag}_raw.png"))
    for name in ("grey.png", "rgb.png", ".gif", "raw.png"):
        sep = "" if name.startswith(".") else "_"
        assert (tmp_path / f"t{sep}{name}").read_bytes() == \
            (tmp_path / f"j{sep}{name}").read_bytes(), name
    # without PIL: the zlib encoder, and a GIF becomes a frame directory
    monkeypatch.setattr(tr, "_HAVE_PIL", False)
    monkeypatch.setattr(jr, "_HAVE_PIL", False)
    for mod, tag in ((tr, "tf"), (jr, "jf")):
        mod.save_png(rgb, str(tmp_path / f"{tag}.png"))
        mod.save_gif(frames, str(tmp_path / f"{tag}_anim.gif"))
    assert (tmp_path / "tf.png").read_bytes() == \
        (tmp_path / "jf.png").read_bytes()
    names = sorted(os.listdir(tmp_path / "tf_anim"))
    assert names == sorted(os.listdir(tmp_path / "jf_anim"))
    assert len(names) == 3
    for f in names:
        assert (tmp_path / "tf_anim" / f).read_bytes() == \
            (tmp_path / "jf_anim" / f).read_bytes()


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A checkpoint of the disk after 3 celllist steps (both CLIs' render
    reads its arrays; the config is the scene's)."""
    from smoothed_particle_hydrodynamics_tpu_torch.ops.step import drive_loop

    cfg, st = make_scene("disk", device="cpu")
    st, _ = drive_loop(cfg, st, 3)
    return tio.save_checkpoint(str(tmp_path_factory.mktemp("ck")), 3, cfg, st)


@pytest.mark.parametrize("flags", [[], ["--voxels"], ["--perspective"],
                                   ["--camera", "135,0.6,1.8"],
                                   ["--camera", "30,-0.2,1.2", "--no-box"]])
def test_render_subcommand_matches_jax_cli(checkpoint, flags, tmp_path,
                                           capsys):
    a, b = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    assert main(["render", checkpoint, "-o", a, "--device", "cpu"]
                + flags) == 0
    out_t = capsys.readouterr().out
    assert jcli.main(["render", checkpoint, "-o", b] + flags) == 0
    out_j = capsys.readouterr().out
    assert out_t == f"wrote {a}\n" and out_j == f"wrote {b}\n"
    assert open(a, "rb").read() == open(b, "rb").read()


def test_render_camera_error_matches_jax(checkpoint, capsys):
    argv = ["render", checkpoint, "-o", "x.png", "--camera", "135,0.6"]
    with pytest.raises(SystemExit) as jerr:
        jcli.main(argv)
    with pytest.raises(SystemExit) as terr:
        main(argv + ["--device", "cpu"])
    assert str(terr.value) == str(jerr.value) == (
        "--camera expects AZ,EL,DIST (e.g. --camera 135,0.6,1.8)")


@pytest.mark.parametrize("backend", ["pairwise", "pallas"])
def test_run_render_live_and_live_term(backend, tmp_path, capsys,
                                       monkeypatch):
    """``run --render --render-every 10 --live P --live-term`` over 30 steps
    in blocks of 10: three GIF frames, the live PNG of the final state
    (byte-equal to a render of ``final_state.npz``), an ANSI repaint per
    block.  The lazy run (pallas) draws from its sorted carry: it unsorts
    only for ``final_state.npz``; the eager run (pairwise) draws its
    state."""
    unsorts = []
    real = tlazy.unsort_carry
    monkeypatch.setattr(tlazy, "unsort_carry",
                        lambda c: unsorts.append(1) or real(c))
    out, live = str(tmp_path / "o"), str(tmp_path / "live.png")
    assert main(["run", "--scene", "splash", "-n", "512", "--device", "cpu",
                 "--backend", backend, "--set", "cell_size_factor=1.25",
                 "--set", "pallas_window_t=64", "--steps", "30", "--block",
                 "10", "--out", out, "--render", "--render-every", "10",
                 "--live", live, "--live-term"]) == 0
    text = capsys.readouterr().out
    assert f"wrote {out}/sph_anim.gif (3 frames)" in text
    assert text.count("\x1b[2J\x1b[H") == 3 and "\nstep 30/30\n" in text
    assert "▀" in text and "\x1b[38;5;" in text
    assert len(unsorts) == (1 if backend == "pallas" else 0)
    from PIL import Image

    with Image.open(f"{out}/sph_anim.gif") as gif:
        assert gif.n_frames == 3
    with open(f"{out}/run.json") as fh:
        cfg = TCfg.from_json(json.dumps(json.load(fh)["config"]))
    final = load_state(f"{out}/final_state.npz", "cpu")
    tr.save_png(tr.render_frame(cfg, final), str(tmp_path / "want.png"))
    assert open(live, "rb").read() == (tmp_path / "want.png").read_bytes()
    assert not os.path.exists(live + ".tmp.png")
