"""Point-splat renderer: PyTorch rasterizer -> PNG frames -> animated GIF
(counterpart of ``smoothed_particle_hydrodynamics_tpu/utils/render.py``).

The reference's Qt/OpenGL viewer draws additive grey points over a black
background, its camera looking down the y axis of the box.  Here the splat
is a count image built on the state's device (``index_add_`` of ones into a
float32 image; counts are integers below 2^24, so the sum is exact in any
order and the image does not depend on particle order), and each frame
comes to the host once, as uint8.  The float32 arithmetic is the JAX
package's on XLA:CPU, contractions included (``physics.fma32``/``dot3``),
so the images are byte-equal to its on any device.

PIL encodes when present; otherwise a dependency-free PNG encoder (zlib) is
used and a GIF becomes a directory of PNG frames, as in the JAX package.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import torch

from ..config import SphConfig, _f32
from ..ops.physics import dot3, fma32
from ..state import ParticleState

try:
    from PIL import Image

    _HAVE_PIL = True
except Exception:  # pragma: no cover
    _HAVE_PIL = False


def _counts(flat: torch.Tensor, size: int,
            weight: torch.Tensor | None = None) -> torch.Tensor:
    """[size] float32 sums of ``weight`` (default 1) at ``flat``."""
    out = torch.zeros(size, dtype=torch.float32, device=flat.device)
    if weight is None:
        weight = torch.ones(flat.shape[0], dtype=torch.float32,
                            device=flat.device)
    return out.index_add_(0, flat.long(), weight)


def _to_u8(counts: torch.Tensor, gain: float) -> torch.Tensor:
    return (counts * _f32(gain)).clamp(0.0, 255.0).to(torch.uint8)


def _splat(pos_xy: torch.Tensor, extent: torch.Tensor, size: int = 512,
           gain: float = 40.0) -> torch.Tensor:
    """Additive point splat of [N, 2] coords into a [size, size] u8 image
    (on the device)."""
    uv = pos_xy / extent
    pix = (uv * size).to(torch.int32).clamp(0, size - 1)
    flat = pix[:, 1] * size + pix[:, 0]
    return _to_u8(_counts(flat, size * size), gain).view(size, size)


def _norm(v: torch.Tensor) -> torch.Tensor:
    """v / max(|v|, 1e-12), |v| a correctly rounded float32 sqrt."""
    return v / torch.sqrt(dot3(v, v).double()).float().clamp(min=1e-12)


def _camera(eye: torch.Tensor, target: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The lookAt basis (right, up, fwd), each [3] float32."""
    fwd = _norm(target - eye)
    # cross(fwd, world_up = +y): (f1*0 - f2*1, f2*0 - f0*0, f0*1 - f1*0)
    zero = fwd[0] * 0.0
    right = _norm(torch.stack([-fwd[2], zero, fwd[0]]))
    # cross(right, fwd), each component's first product fused
    r, f = right, fwd
    up = torch.stack([fma32(r[1], f[2], -(r[2] * f[1])),
                      fma32(r[2], f[0], -(r[0] * f[2])),
                      fma32(r[0], f[1], -(r[1] * f[0]))])
    return right, up, fwd


def _splat_perspective(pos: torch.Tensor, eye: torch.Tensor,
                       target: torch.Tensor, size: int = 512,
                       gain: float = 40.0,
                       tan_half_fov: float = 0.5) -> torch.Tensor:
    """Perspective point splat: lookAt basis + frustum divide, like the
    reference's gluPerspective/lookAt camera (on the device)."""
    right, up, fwd = _camera(eye, target)
    rel = pos - eye
    xc, yc, zc = dot3(rel, right), dot3(rel, up), dot3(rel, fwd)
    near = _f32(1e-3)
    zc_safe = zc.clamp(min=near)
    u = xc / (zc_safe * tan_half_fov)          # [-1, 1] at the fov edge
    v = yc / (zc_safe * tan_half_fov)
    visible = (zc > near) & (u.abs() < 1.0) & (v.abs() < 1.0)
    px = ((u * 0.5 + 0.5) * size).to(torch.int32).clamp(0, size - 1)
    py = ((0.5 - v * 0.5) * size).to(torch.int32).clamp(0, size - 1)
    flat = torch.where(visible, py * size + px, 0)
    counts = _counts(flat, size * size, visible.to(torch.float32))
    return _to_u8(counts, gain).view(size, size)


def _box_edge_points(cfg: SphConfig, samples: int = 192) -> np.ndarray:
    """[12*samples, 3] points along the simulation box's 12 edges."""
    bx, by, bz = (float(v) for v in cfg.box_max)
    corners = np.asarray([[x, y, z] for x in (0.0, bx) for y in (0.0, by)
                          for z in (0.0, bz)], np.float32)
    edges = [(a, b) for a in range(8) for b in range(a + 1, 8)
             if sum(corners[a] != corners[b]) == 1]
    t = np.linspace(0.0, 1.0, samples, dtype=np.float32)[:, None]
    return np.concatenate([corners[a] * (1 - t) + corners[b] * t
                           for a, b in edges], axis=0)


def render_frame_perspective(cfg: SphConfig, state: ParticleState,
                             size: int = 512, gain: float = 40.0,
                             elevation: float = 0.45,
                             distance: float = 1.6,
                             azimuth: float = 180.0,
                             box: bool = True) -> np.ndarray:
    """3-D perspective view: the camera orbits the box, looking at its
    center (the reference's GL frustum + lookAt camera normalized by box
    size).  ``azimuth`` (degrees around +y; 180 = the -z view),
    ``elevation`` (camera height as a fraction of the box span) and
    ``distance`` (eye distance in box spans) are the view controls; ``box``
    overlays the wireframe box outline the reference draws."""
    dev = state.position.device
    box_max = np.asarray(cfg.box_max, np.float32)
    center = box_max * np.float32(0.5)
    span = float(box_max.max())
    az = float(np.deg2rad(azimuth))
    eye = center + np.asarray(
        [distance * span * np.sin(az), elevation * span,
         distance * span * np.cos(az)], np.float32)
    eye_t = torch.from_numpy(eye).to(dev)
    center_t = torch.from_numpy(center).to(dev)
    img = _splat_perspective(state.position, eye_t, center_t, size=size,
                             gain=gain)
    if box:
        # the wireframe: dense samples of the 12 edges through the same
        # camera, a dim fixed shade under the particles
        edge = _splat_perspective(
            torch.from_numpy(_box_edge_points(cfg)).to(dev), eye_t,
            center_t, size=size, gain=255.0)
        img = torch.maximum(img, edge.clamp(max=64))
    return img.cpu().numpy()


def render_frame(cfg: SphConfig, state: ParticleState, size: int = 512,
                 axis: str = "xz", gain: float = 40.0,
                 voxels: bool = False) -> np.ndarray:
    """One frame of the particle cloud: greyscale [size, size] u8 (the
    reference's additive point blending); with ``voxels=True`` RGB
    [size, size, 3] with the occupied grid cells shaded red at 0.02 x their
    occupancy (the reference's drawVoxels overlay).  The state may be in
    any particle order (a lazy run's sorted carry)."""
    from ..ops.grid import cell_coords

    ax = {"x": 0, "y": 1, "z": 2}
    a, b = ax[axis[0]], ax[axis[1]]
    pos = state.position
    extent = torch.tensor([cfg.box_max[a], cfg.box_max[b]],
                          dtype=torch.float32, device=pos.device)
    grey = _splat(pos[:, [a, b]], extent, size=size, gain=gain)
    if not voxels:
        return grey.cpu().numpy()
    # cell occupancy projected along the remaining axis
    dims = {0: cfg.grid_nx, 1: cfg.grid_ny, 2: cfg.grid_nz}
    coords = cell_coords(cfg, pos)
    flat = coords[:, a] * dims[b] + coords[:, b]
    vox = _to_u8(_counts(flat, dims[a] * dims[b]), 0.02 * 255.0)
    # one copy to the host for both images
    both = torch.cat([grey.view(-1), vox]).cpu().numpy()
    grey = both[:size * size].reshape(size, size)
    vox = both[size * size:].reshape(dims[a], dims[b])
    # upsample nearest to the image size
    reps = (size // vox.shape[0] + 1, size // vox.shape[1] + 1)
    vox_img = np.kron(vox, np.ones(reps, np.uint8))[:size, :size]
    return np.stack([np.maximum(grey, vox_img), grey, grey], axis=-1)


def ansi_frame(img: np.ndarray, cols: int = 80, rows: int = 24) -> str:
    """Greyscale image -> ANSI half-block string, the in-terminal live view:
    each character cell renders two vertically stacked pixels with the
    upper-half-block glyph (foreground = top, background = bottom) on the
    24-level xterm-256 greyscale ramp.  Downsampling is block-max so sparse
    splats stay visible at 80x24."""
    if img.ndim == 3:
        img = img.max(axis=-1)
    h, w = img.shape
    ph, pw = rows * 2, cols
    # block-max pool onto a (2*rows, cols) pixel grid
    ys = np.minimum((np.arange(ph + 1) * h) // ph, h)
    xs = np.minimum((np.arange(pw + 1) * w) // pw, w)
    pix = np.zeros((ph, pw), np.uint8)
    for r in range(ph):
        row = img[ys[r]:max(ys[r + 1], ys[r] + 1)]
        pix[r] = np.maximum.reduceat(row.max(axis=0), xs[:-1])
    # xterm-256 greyscale ramp: 232 (near black) .. 255 (near white)
    shade = 232 + (pix.astype(np.int32) * 24) // 256
    out = []
    for r in range(rows):
        line = [f"\x1b[38;5;{shade[2 * r, c]}m"
                f"\x1b[48;5;{shade[2 * r + 1, c]}m▀" for c in range(cols)]
        out.append("".join(line) + "\x1b[0m")
    return "\n".join(out)


def save_png(img: np.ndarray, path: str) -> None:
    if _HAVE_PIL:
        Image.fromarray(img, mode="L" if img.ndim == 2 else "RGB").save(path)
        return
    if img.ndim == 3:
        img = img.max(axis=-1)
    _write_png_gray(img, path)


def save_gif(frames: list[np.ndarray], path: str,
             duration_ms: int = 50) -> None:
    """Animated GIF (the reference README's sph_anim.gif); without PIL, the
    frames as numbered PNGs in a directory named after ``path``."""
    if _HAVE_PIL:
        imgs = [Image.fromarray(f, mode="L").convert("P") for f in frames]
        imgs[0].save(path, save_all=True, append_images=imgs[1:],
                     duration=duration_ms, loop=0)
        return
    stem, _ = os.path.splitext(path)
    os.makedirs(stem, exist_ok=True)
    for i, f in enumerate(frames):
        _write_png_gray(f, f"{stem}/frame_{i:05d}.png")


def _write_png_gray(img: np.ndarray, path: str) -> None:
    """Minimal dependency-free 8-bit greyscale PNG encoder."""
    h, w = img.shape
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return struct.pack(">I", len(data)) + body + struct.pack(
            ">I", zlib.crc32(body) & 0xFFFFFFFF)

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))
