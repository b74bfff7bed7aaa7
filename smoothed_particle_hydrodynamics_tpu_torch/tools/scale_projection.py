"""Strong-scaling projection on the card: counterpart of
``tools/scale_projection.py``.

    python -m smoothed_particle_hydrodynamics_tpu_torch.tools.scale_projection \\
        [--sizes 125000,250000,500000,1000000,1250000] [--chips 8] \\
        [--rows slab_1dev,slab_capped_k4] [--out F.json] [--append] \\
        [--device cpu]

A D-card slab run gives each card a z slab of the full scene: ~N/D
particles at the full pool depth over 1/D of the z extent.  The proxy runs
the slab engine on a one-rank group (``bench --partition slab``) with n =
N/D particles in a ``grid_nz = 128/D``-plane box: the same particles per
plane, occupancy and window structure as one card of the real run.  The
halo and migration code runs (at world 1 a ring shift hands the tensor
back, and the chain ends are inert), so what the proxy leaves out is the
hop between cards and the imbalance between them.

The hop is modeled into every row instead: the measured caps (``h_cap``,
``m_cap``) give the bytes the port's slab step sends (``HALO_COLS``,
``MIGRATION_COLS``), timed at the H100 SXM's published NVLink bandwidth
(``NVLINK_BYTES_PER_S``, a datasheet peak, so this bytes term is a lower
bound), plus the collectives a step and a rebin issue (``STEP_COLLECTIVES``,
``REBIN_COLLECTIVES``), each priced at what one launch costs on this card
as ``tools/probe_dispatch.py`` measures it in the same run: its ``x + 1``
over the splash's 1M x 3 f32 positions, so the price holds the host's
dispatch and the ~24 MB that op reads and writes, and is no bound.  The
port's multi-rank path measured so far, two gloo ranks sharing one card
(``run --devices 2``), stages every message through the host and says
nothing of NVLink.

Each ``(row, size)`` runs in a fresh subprocess of the port's CLI, as the
JAX tool runs ``bench.py --row`` (in-process sequences of large
benchmarks contaminate each other there, ``bench.py:39-45``).  The rows
are ``bench.py``'s ``slab_1dev`` and ``slab_capped_k4`` (``ROWS``); a spec
``name:k=v:...`` adds ``--set k=v`` and ``scan_block=K`` in a spec replaces
the per-size policy (``scan_block_for``).  The port's ``scan_block`` only
loops the same step (``parallel/slabs.py``, ``make_slab_step``): it is
passed and recorded as ``bench.py`` records it and changes no dispatch.
A row whose process fails is printed, recorded under ``failed`` and
skipped; the record is written after every row (default
``docs/scale_projection_torch.json``, beside the JAX package's TPU record
``docs/scale_projection.json``) with the card's name and power limit.
Each row is one run (``runs_per_row`` in the record), as in the JAX tool,
so two sizes' times differ by no more than the spread between runs can.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from . import card_line, start

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PKG = "smoothed_particle_hydrodynamics_tpu_torch"
DEFAULT_OUT = os.path.join(REPO, "docs", "scale_projection_torch.json")
SIZES = "125000,250000,500000,1000000,1250000"

# bench.py's two slab rows (bench.py:147-167), as the config overrides
# run_slab_benchmark applies: its own 1.25h cells (utils/benchmark.py), and
# the capped row's K_c 4 on 256-row blocks, window and sub frame derived
ROWS = {
    "slab_1dev": dict(cell_size_factor=1.25),
    "slab_capped_k4": dict(cell_size_factor=1.25, capped_candidates=4,
                           pallas_window_t=0, pallas_block_t=256),
}
# the JAX tool passes --warmup 5; bench.py's slab rows leave it to
# run_slab_benchmark's 3, and at every K >= 5 both are one call of K steps
WARMUP = 5
# the capped density's measured noise at 1M, by cell_size_factor: rel-L2 of
# the capped K4 reweighted density against the exact one on the same state
# (a density noise of the JAX package's sampling, docs/noise_ladder_r5.log)
NOISE = {1.25: 0.36, 2.0: 0.758, 2.5: 1.204, 4.0: 2.55, 5.0: 3.52,
         6.0: 4.17}

# --- the hop model ----------------------------------------------------------
# NVIDIA H100 SXM datasheet: fourth-generation NVLink, 900 GB/s of
# bidirectional bandwidth per GPU, so 450 GB/s each way.  A published peak,
# not a measurement.
NVLINK_BYTES_PER_S = 450e9
LINK_SOURCE = ("NVIDIA H100 SXM datasheet: NVLink 4, 900 GB/s bidirectional "
               "per GPU = 450 GB/s each way; a datasheet peak, not a "
               "measurement, so the hop's bytes term is a lower bound")
F32 = 4
# f32 columns a halo row carries per direction and step (parallel/slabs.py):
# prepare_frame's message, the 8 store columns with the cell id's bits as a
# ninth (halo_msg), and exchange_rho's density.  Forty bytes a row, as the
# JAX model counts (its fields 8 + cid 1 + rho 1), in two messages, not
# three.
HALO_COLS = 8 + 1 + 1
# f32 columns of a migrated row (_migrate's hop: store rows), 32 bytes as
# in the JAX model
MIGRATION_COLS = 8
# collectives a rank issues a step: 4 ring shifts (one batch_isend_irecv
# each: prepare_frame's two halo messages, exchange_rho's two) and 3
# all_reduces (the rebin decision's pmax, the diagnostics' psum and pmax);
# the JAX model counts 8 (six ppermutes, its fields and cids apart, and
# two reductions)
STEP_COLLECTIVES = 4 + 3
# a rebin with one hop of migration (the JAX model's "~1 hop typical"):
# the pending psum before and after it and the hop's 2 ring shifts; the
# JAX model counts 2
REBIN_COLLECTIVES = 2 + 2


def parse_rows(spec: str) -> list[tuple[str, list[str], int]]:
    """``name`` or ``name:k=v:...`` specs, comma-separated -> (name, the
    k=v overrides, the spec's scan_block or 0), as the JAX tool parses."""
    rows = []
    for part in spec.split(","):
        name, *ovs = part.split(":")
        sb = [o for o in ovs if o.startswith("scan_block=")]
        ovs = [o for o in ovs if not o.startswith("scan_block=")]
        if name not in ROWS:
            raise SystemExit(f"unknown row {name!r}; rows: {sorted(ROWS)}")
        rows.append((name, ovs, int(sb[-1].split("=")[1]) if sb else 0))
    return rows


def grid_nz_for(chips: int) -> int:
    """The slab proxy's z planes: each of D cards owns 128/D planes of the
    splash's 128 (0, the scene's own, when that is not a whole number of
    at least 2 planes)."""
    return 128 // chips if 128 % chips == 0 and 128 // chips >= 2 else 0


def scan_block_for(n: int, spec: int = 0) -> int:
    """The JAX tool's steps a dispatch by size, unless the spec names one."""
    return spec or (32 if n <= 250_000 else (16 if n <= 500_000 else 8))


def bench_steps(scan_block: int) -> int:
    """The measured steps ``bench.py --row`` runs for the JAX tool: it asks
    for ``max(9 K, 50)``, the row measures a third of that, at least 10,
    and at least 3 calls of ``K or 8`` steps."""
    return max(max(max(9 * scan_block, 50) // 3, 10), 3 * (scan_block or 8))


def noise(row: str, ovs: list[str]) -> float | None:
    """The capped row's density noise at its cell size (None off the
    ladder or for an exact row)."""
    csf = next((float(o.split("=")[1]) for o in ovs
                if o.startswith("cell_size_factor=")),
               1.25 if "capped" in row else None)
    return NOISE.get(csf) if "capped" in row else None


def bench_argv(row: str, n: int, grid_nz: int, scan_block: int,
               ovs: list[str], device: str) -> list[str]:
    """The port's CLI call for one row and size."""
    argv = ["bench", "--partition", "slab", "--scene", "splash", "-n", str(n),
            "--steps", str(bench_steps(scan_block)), "--warmup",
            str(WARMUP), "--slab-sweeps", "pallas", "--scan-block",
            str(scan_block), "--device", device]
    sets = {k: json.dumps(v) for k, v in ROWS[row].items()}
    if grid_nz:
        sets["grid_nz"] = str(grid_nz)
    for kv in ovs:       # the spec's k=v win, as bench.py's --ov do
        k, _, v = kv.partition("=")
        sets[k] = v
    for k, v in sets.items():
        argv += ["--set", f"{k}={v}"]
    return argv


def hop_bytes(h_cap: int, m_cap: int) -> dict:
    """Bytes a rank sends: a step's halo, both directions, and one
    migration hop's, both directions."""
    return {"halo_bytes_per_step": 2 * h_cap * HALO_COLS * F32,
            "migration_bytes_per_rebin": 2 * m_cap * MIGRATION_COLS * F32}


def link_ms(h_cap: int, m_cap: int, rebins: int, steps: int,
            launch_ms: float) -> dict:
    """The modeled hop a step: the halo's bytes over the link plus the
    step's collectives at ``launch_ms`` each, and a rebin's migration hop
    and collectives amortized over the measured rebin cadence."""
    b = hop_bytes(h_cap, m_cap)
    per_step = (b["halo_bytes_per_step"] / NVLINK_BYTES_PER_S * 1e3
                + STEP_COLLECTIVES * launch_ms)
    per_rebin = (b["migration_bytes_per_rebin"] / NVLINK_BYTES_PER_S * 1e3
                 + REBIN_COLLECTIVES * launch_ms)
    amort = per_rebin * (rebins / steps if steps else 0.0)
    return {**b, "link_ms_per_step": per_step + amort}


def run_row(row: str, n: int, grid_nz: int, scan_block: int,
            ovs: list[str], device: str, timeout: float
            ) -> tuple[dict | None, dict]:
    """One row in a fresh process: (its bench record or None, what went
    wrong: the exit code and the end of its errors)."""
    cmd = [sys.executable, "-m", PKG, *bench_argv(row, n, grid_nz,
                                                  scan_block, ovs, device)]
    fault = {}
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=timeout, cwd=REPO)
        fault = {"rc": out.returncode, "tail": out.stderr[-400:]}
        return json.loads(out.stdout.strip().splitlines()[-1]), fault
    except subprocess.TimeoutExpired:
        fault = {"rc": "timeout", "tail": f"killed at {timeout:.0f} s"}
    except Exception as e:  # noqa: BLE001 - record the failure, keep going
        fault.setdefault("rc", None)
        fault["error"] = repr(e)
    return None, fault


def record(label: str, row: str, ovs: list[str], n: int, grid_nz: int,
           scan_block: int, chips: int, r: dict, launch_ms: float) -> dict:
    """A measured row in the JAX record's keys, ``link`` for its ``ici``,
    plus the counted losses of every step, warmup included."""
    ms = r["ms_per_step"]
    rec = {"row": label, "n_per_chip": n, "grid_nz": grid_nz,
           "scan_block": scan_block}
    if noise(row, ovs) is not None:
        rec["noise_rel_l2_1m"] = noise(row, ovs)
    rec.update({
        "ms_per_step": ms, "pps_per_chip": n / ms * 1e3,
        "aggregate_n": n * chips,
        f"projected_pps_x{chips}": n * chips / ms * 1e3,
        "steps": r["steps"], "rebins": r["rebins"],
        "migration_dropped": max(r["migration_dropped_steps"]),
        "halo_dropped": max(r["halo_dropped_steps"]),
        "truncated_ranges": max(r["truncated_ranges"]),
        "finite": r["finite"], "p_cap": r["p_cap"], "h_cap": r["h_cap"],
        "m_cap": r["m_cap"], "window_t": r["window_t"],
        "sub_len": r["sub_len"]})
    link = link_ms(r["h_cap"], r["m_cap"], r["rebins"], r["steps"],
                   launch_ms)
    rec.update(link)
    rec["ms_per_step_with_link"] = ms + link["link_ms_per_step"]
    rec[f"projected_pps_x{chips}_with_link"] = (
        n * chips / rec["ms_per_step_with_link"] * 1e3)
    return rec


def lossless(rec: dict) -> bool:
    """No row dropped in migration or the halo, no truncated candidate,
    a finite state."""
    return (rec["migration_dropped"] == 0 and rec["halo_dropped"] == 0
            and rec["truncated_ranges"] == 0 and rec["finite"])


def table(doc: dict) -> str:
    d = doc["chips"]
    key = f"projected_pps_x{d}"
    lines = [f"| mode | n/chip | ms/step | pps/chip | {d}-chip aggregate N "
             f"| projected {d}-chip pps | with link (NVLink datasheet peak) "
             f"|", "|---|---|---|---|---|---|---|"]
    for r in doc["rows"]:
        lines.append(
            f"| {r['row']} | {r['n_per_chip']:,} | {r['ms_per_step']:.4f} "
            f"| {r['pps_per_chip']:.4g} | {r['aggregate_n']:,} "
            f"| {r[key]:.4g} | {r[key + '_with_link']:.4g} |")
    return "\n".join(lines)


def main(sizes: str = SIZES, chips: int = 8,
         rows: str = "slab_1dev,slab_capped_k4", out: str = DEFAULT_OUT,
         append: bool = False, device="cuda", timeout: float = 1800.0
         ) -> dict:
    dev = start(device)
    from .probe_dispatch import ONE_LAUNCH, SPLASH_N, one_launch_ms

    specs = parse_rows(rows)
    grid_nz = grid_nz_for(chips)
    launch = one_launch_ms(SPLASH_N, dev)
    doc = {"chips": chips, "device": card_line(dev), "package": PKG,
           "link": {"bytes_per_s": NVLINK_BYTES_PER_S,
                    "source": LINK_SOURCE},
           "launch": {"ms": launch, "source": (
               f"tools/probe_dispatch.py '{ONE_LAUNCH}' over the "
               f"{SPLASH_N:,}-particle splash's positions ({SPLASH_N:,} x 3 "
               f"f32, ~24 MB read and written), host clock ended by a "
               f"device sync, this run: one launch's host cost and that "
               f"op's device work stand in for a collective's, no bound")},
           "runs_per_row": 1,
           "collectives": {"per_step": STEP_COLLECTIVES,
                           "per_rebin": REBIN_COLLECTIVES,
                           "halo_cols": HALO_COLS,
                           "migration_cols": MIGRATION_COLS},
           "rows": [], "failed": []}
    if append and os.path.exists(out):
        with open(out) as f:
            old = json.load(f)
        doc["rows"], doc["failed"] = old["rows"], old.get("failed", [])
    for n in [int(s) for s in sizes.split(",")]:
        for row, ovs, sb_spec in specs:
            scan_block = scan_block_for(n, sb_spec)
            label = row + "".join("+" + o for o in ovs)
            print(f"measuring {label} @ n/chip={n} grid_nz={grid_nz} "
                  f"scan_block={scan_block} ...", flush=True)
            r, fault = run_row(row, n, grid_nz, scan_block, ovs, str(dev),
                               timeout)
            if r is None:
                print(f"  ROW FAILED {label} n={n}: {fault}", flush=True)
                doc["failed"].append({"row": label, "n_per_chip": n,
                                      **fault})
            else:
                rec = record(label, row, ovs, n, grid_nz, scan_block, chips,
                             r, launch)
                doc["rows"].append(rec)
                print("  " + json.dumps(rec), flush=True)
            # write as we go: a cut run keeps the rows it finished
            os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
            with open(out, "w") as f:
                json.dump(doc, f, indent=1)
    print(f"\nwrote {out}\n")
    print(f"link: {LINK_SOURCE}; per collective {launch:.4f} ms "
          f"(probe_dispatch's one launch over 24 MB: host and device)")
    print(table(doc))
    bad = [r["row"] + f" @ {r['n_per_chip']}" for r in doc["rows"]
           if not lossless(r)]
    if bad:
        print(f"rows that lost particles or candidates: {bad}")
    return doc


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m smoothed_particle_hydrodynamics_tpu_torch.tools."
             "scale_projection")
    ap.add_argument("--sizes", default=SIZES)
    ap.add_argument("--chips", type=int, default=8)
    ap.add_argument("--rows", default="slab_1dev,slab_capped_k4")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--append", action="store_true",
                    help="keep the rows already in --out")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    main(a.sizes, a.chips, a.rows, a.out, a.append, a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
