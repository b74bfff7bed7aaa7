"""The reference against brute force over every pair, and the bfloat16
control against the limits: the control must fail them."""

import json

import numpy as np
import pytest
import torch

import compare
import core
import reference
import spec


def _constants(n):
    config = json.loads((core.HERE / "configs" / "splash_1m_exact.json")
                        .read_text())
    config["sph"].update(num_particles=n, grid_nx=8, grid_ny=8, grid_nz=8)
    return spec.constants(config["sph"])


def _state(c, n, seed):
    g = torch.Generator().manual_seed(seed)
    box = torch.tensor(c["box"])
    pos = torch.rand(n, 3, generator=g) * box
    pos[:40] = pos[40:80].clone()            # coincident pairs (d = 0)
    pos[80:100, 0] = 0.0                     # on a wall
    pos[100:120] = torch.round(pos[100:120] / c["h"]) * c["h"]  # on h edges
    vel = torch.randn(n, 3, generator=g)
    mass = 1.0 + torch.rand(n, generator=g)
    return pos, vel, mass


def _brute(c, pos, vel, mass, kept=None, mass_c=None):
    """Every pair, float32 d^2 in the specification's order, sums in
    float64; with ``kept`` only the kept candidates, of masses
    ``mass_c``."""
    d = pos[None, :, :] - pos[:, None, :]          # [i, j] = p_j - p_i
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    n = pos.shape[0]
    mask = (d2 < c["h2"]) & ~torch.eye(n, dtype=torch.bool)
    if kept is not None:
        mask &= kept[None, :]
    m, d2d = mass.double(), d2.double()
    mc = m if mass_c is None else mass_c.double()
    t = c["h_s2"] - d2d
    w = torch.where(mask, mc[None, :] * c["poly6"] * t ** 3, 0.0)
    rho = w.sum(1) + m * c["poly6"] * c["h_s2"] ** 3
    rinv = 1.0 / rho
    pw = (rho - c["rho0"]) * c["stiffness"] * rinv * rinv
    r = torch.sqrt(d2d)
    hd = torch.where(mask, c["h_s"] - r, 0.0)
    center = hd * hd * mc[None, :] * (pw[:, None] + pw[None, :]) / (r + c["eps"])
    press = -(d.double() * center[..., None]).sum(1) * c["visc_norm"]
    dv = vel.double()[None, :, :] - vel.double()[:, None, :]
    vw = hd * rinv[None, :] * mc[None, :]
    visc = (dv * vw[..., None]).sum(1) * c["visc_norm"] * c["viscosity"] \
        * rinv[:, None]
    acc = press + visc + torch.tensor(c["gravity"], dtype=torch.float64)
    return {"count": mask.sum(1), "rho": rho, "acc": acc}


@pytest.mark.parametrize("seed", [1, 2])
def test_reference_matches_brute_force(seed):
    n = 1500
    c = _constants(n)
    pos, vel, mass = _state(c, n, seed)
    ref = reference.step(c, pos, vel, mass)
    brute = _brute(c, pos, vel, mass)
    assert torch.equal(ref["count"].long(), brute["count"])
    assert brute["count"].float().mean() > 2
    assert ((ref["rho"].double() - brute["rho"]).abs()
            / brute["rho"]).max() < 1e-5
    err = (ref["acc"].double() - brute["acc"]).norm(dim=1).max()
    assert err / brute["acc"].norm(dim=1).square().mean().sqrt() < 1e-5
    # the integrator: kick, drift, the box
    v_half = vel + ref["acc"] * (c["dt"] * 0.5)
    inside = ((pos + v_half * c["pos_dt"] > 0)
              & (pos + v_half * c["pos_dt"] < torch.tensor(c["box"]))).all(1)
    assert torch.allclose(ref["vel"][inside], v_half[inside])
    assert torch.allclose(ref["pos"][inside],
                          (pos + v_half * c["pos_dt"])[inside])
    assert (ref["pos"] >= 0).all() and (ref["pos"] <= torch.tensor(c["box"])).all()


def _capped_constants(n, grid, k_c, reweight):
    config = json.loads((core.HERE / "configs" / "splash_1m_exact.json")
                        .read_text())
    config["sph"].update(num_particles=n, grid_nx=grid, grid_ny=grid,
                         grid_nz=grid, capped_candidates=k_c,
                         capped_reweight=reweight)
    return spec.constants(config["sph"])


def _capped_state(c, n, seed):
    """A state packed into 3^3 cells of the bins' grid (about 22 to a
    cell), and its bins: a frame unlike the step's (the rows permuted) and
    the positions it was built from, each within the skin of 1.25h cells
    (a quarter of h) of the step's."""
    g = torch.Generator().manual_seed(seed)
    cell = c["box"][0] / c["grid"][0]
    pos = c["box"][0] * 0.5 + torch.rand(n, 3, generator=g) * (3 * cell)
    pos[:20] = pos[20:40].clone()                 # coincident pairs
    vel = torch.randn(n, 3, generator=g)
    mass = 1.0 + torch.rand(n, generator=g)
    skin = 0.125 * c["h"]
    bin_pos = pos + (2 * torch.rand(n, 3, generator=g) - 1) * skin
    bin_row = torch.randperm(n, generator=g)
    return pos, vel, mass, {"pos": bin_pos, "row": bin_row}


def _brute_kept(c, bins):
    """The kept set and candidate weights by their definition, one
    particle against every other: a particle's rank is the number of its
    cell's particles whose (key, row) sorts before its own."""
    xyz = np.floor(bins["pos"].numpy() * np.float32(c["inv_cell"]))
    xyz = np.clip(xyz.astype(np.int64), 0, np.array(c["grid"]) - 1)
    nx, ny, _ = c["grid"]
    cell = (xyz[:, 2] * ny + xyz[:, 1]) * nx + xyz[:, 0]
    row = bins["row"].numpy().astype(np.int64)
    key = row * 2654435769 % 2 ** 31
    if c["hash_bits"] >= 8:
        key >>= 31 - c["hash_bits"]
    same = cell[:, None] == cell[None, :]
    ahead = ((key[None, :] < key[:, None])
             | ((key[None, :] == key[:, None]) & (row[None, :] < row[:, None])))
    rank = (same & ahead).sum(1)
    occ = same.sum(1)
    weight = np.ones(len(row), np.float32)
    if c["capped_reweight"]:
        weight = (occ.astype(np.float32)
                  / np.minimum(occ, c["k_c"]).astype(np.float32))
    return torch.from_numpy(rank < c["k_c"]), torch.from_numpy(weight)


@pytest.mark.parametrize("reweight", [True, False])
@pytest.mark.parametrize("grid,packed", [(128, True), (256, False)])
def test_capped_reference_matches_brute_force(grid, packed, reweight):
    """Both hash branches: the packed key of the top hash bits where the
    grid's 128^3 cells spare 10 bits of an int32, the whole hash where
    256^3 cells spare 7."""
    n = 600
    c = _capped_constants(n, grid, 4, reweight)
    assert (c["hash_bits"] >= 8) is packed
    pos, vel, mass, bins = _capped_state(c, n, grid + reweight)
    ref = reference.step(c, pos, vel, mass, bins=bins)
    kept, weight = _brute_kept(c, bins)
    assert 0 < kept.sum() < n / 2
    assert bool((weight > 1).any()) is reweight
    k_ref, w_ref = reference.kept_set(c, bins["pos"], bins["row"])
    assert torch.equal(k_ref, kept) and torch.equal(w_ref, weight)
    brute = _brute(c, pos, vel, mass, kept, mass * weight)
    assert torch.equal(ref["count"].long(), brute["count"])
    assert brute["count"].float().mean() > 2
    assert ((ref["rho"].double() - brute["rho"]).abs()
            / brute["rho"]).max() < 1e-5
    err = (ref["acc"].double() - brute["acc"]).norm(dim=1).max()
    assert err / brute["acc"].norm(dim=1).square().mean().sqrt() < 1e-5
    # the bins decide: the step's own positions and rows keep another set
    own = reference.kept_set(c, pos, torch.arange(n))[0]
    assert not torch.equal(own, kept)


def test_kept_set_breaks_ties_by_row():
    """Five particles of one cell, two of them on one packed key at ranks
    3 and 4: the lower row is kept, whichever comes first in the callers'
    order."""
    c = _capped_constants(600, 128, 4, True)
    shift = 31 - c["hash_bits"]
    key = (torch.arange(600) * 2654435769 % 2 ** 31) >> shift
    buckets = {}
    for r, k in enumerate(key.tolist()):
        buckets.setdefault(k, []).append(r)
    k_tie = min(k for k, rows in buckets.items() if len(rows) > 1
                and sum(len(buckets.get(j, ())) for j in range(k)) >= 3)
    low, high = buckets[k_tie][:2]
    below = [r for j in sorted(buckets) if j < k_tie for r in buckets[j]][:3]
    # the higher row first in the callers' order
    rows = torch.tensor([high, *below, low])
    pos = torch.full((5, 3), c["box"][0] * 0.5)
    kept, weight = reference.kept_set(c, pos, rows)
    assert kept.tolist() == [False, True, True, True, True]
    b_kept, b_weight = _brute_kept(c, {"pos": pos, "row": rows})
    assert torch.equal(kept, b_kept) and torch.equal(weight, b_weight)
    assert torch.allclose(weight, torch.full((5,), 1.25))


def test_capped_reference_needs_the_bins():
    c = _capped_constants(600, 128, 4, True)
    pos, vel, mass, _ = _capped_state(c, 600, 1)
    with pytest.raises(ValueError):
        reference.step(c, pos, vel, mass)


def test_bfloat16_control_fails_the_limits():
    n = 3000
    c = _constants(n)
    pos, vel, mass = _state(c, n, 3)
    ref = reference.step(c, pos, vel, mass)
    low = reference.step(c, pos, vel, mass, dtype=torch.bfloat16)
    nums = compare.step_numbers(low, ref, c["h"])
    for name in ("splash_1m_exact", "dam_break_10m_exact"):
        limits = json.loads((core.HERE / "limits" / f"{name}.json")
                            .read_text())
        ok, table = compare.judge(nums, limits)
        assert not ok
        assert sum(t["value"] > t["limit"] for t in table.values()) >= 3
    same = compare.step_numbers(ref, ref, c["h"])
    assert all(v == 0 for v in same.values())
