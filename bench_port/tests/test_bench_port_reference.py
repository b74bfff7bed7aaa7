"""The reference against brute force over every pair, and the bfloat16
control against the limits: the control must fail them."""

import json

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


def _brute(c, pos, vel, mass):
    """Every pair, float32 d^2 in the specification's order, sums in
    float64."""
    d = pos[None, :, :] - pos[:, None, :]          # [i, j] = p_j - p_i
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    n = pos.shape[0]
    mask = (d2 < c["h2"]) & ~torch.eye(n, dtype=torch.bool)
    m, d2d = mass.double(), d2.double()
    t = c["h_s2"] - d2d
    w = torch.where(mask, m[None, :] * c["poly6"] * t ** 3, 0.0)
    rho = w.sum(1) + m * c["poly6"] * c["h_s2"] ** 3
    rinv = 1.0 / rho
    pw = (rho - c["rho0"]) * c["stiffness"] * rinv * rinv
    r = torch.sqrt(d2d)
    hd = torch.where(mask, c["h_s"] - r, 0.0)
    center = hd * hd * m[None, :] * (pw[:, None] + pw[None, :]) / (r + c["eps"])
    press = -(d.double() * center[..., None]).sum(1) * c["visc_norm"]
    dv = vel.double()[None, :, :] - vel.double()[:, None, :]
    vw = hd * rinv[None, :] * m[None, :]
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
