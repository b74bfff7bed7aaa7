"""Run a command in a session of its own and report the processes of that
session that outlive it.

    python -m smoothed_particle_hydrodynamics_tpu_torch.utils.leftover \\
        [--out report.json] -- python3 chip_smoke.py

The command's output passes through.  While it runs, the session's
processes are sampled every 0.2 s; when it exits, the session is read at
once and again after 0.05, 0.2, 0.5, 1, 2 and 5 s.  The last line of
standard output is one JSON object: the command's exit code, the processes
seen while it ran (pid: command line) and, for each reading after the exit,
the processes still there (pid: [state, parent pid, command line]).  The
exit code is the command's, or 1 when it exited 0 but left a process at
the first reading.  Linux only (reads ``/proc``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

AFTER_S = (0.0, 0.05, 0.2, 0.5, 1.0, 2.0, 5.0)


def session_processes(sid: int) -> dict[int, tuple[str, int, str]]:
    """Every process of session ``sid`` but its leader: pid -> (state,
    parent pid, command line)."""
    out = {}
    for name in os.listdir("/proc"):
        if not name.isdigit() or int(name) == sid:
            continue
        try:
            with open(f"/proc/{name}/stat") as fh:
                stat = fh.read()
            with open(f"/proc/{name}/cmdline", "rb") as fh:
                cmd = fh.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:   # exited while being read
            continue
        fields = stat[stat.rindex(")") + 2:].split()
        if int(fields[3]) == sid:
            out[int(name)] = (fields[0], int(fields[1]), cmd.strip()[:200])
    return out


def watch(cmd: list[str]) -> dict:
    """Run ``cmd`` as a session leader; its exit code, the processes seen
    while it ran and the readings after it exited."""
    proc = subprocess.Popen(cmd, start_new_session=True)
    seen: dict[int, str] = {}
    done = threading.Event()

    def sample():
        while not done.is_set():
            for pid, (_, _, line) in session_processes(proc.pid).items():
                seen[pid] = line   # the latest, after any exec
            done.wait(0.2)

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    rc = proc.wait()
    t_exit = time.monotonic()
    done.set()
    sampler.join()
    after = []
    for t in AFTER_S:
        time.sleep(max(t - (time.monotonic() - t_exit), 0.0))
        left = session_processes(proc.pid)
        after.append({"t": t, "left": {str(k): v for k, v in left.items()}})
        if not left:
            break
    return {"rc": rc, "seen": {str(k): v for k, v in seen.items()},
            "after_exit": after}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the report here")
    ap.add_argument("cmd", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd[:1] == ["--"] else args.cmd
    if not cmd:
        ap.error("no command given")
    report = watch(cmd)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=1)
    print(json.dumps(report), flush=True)
    if report["rc"] == 0 and report["after_exit"][0]["left"]:
        return 1
    return report["rc"]


if __name__ == "__main__":
    sys.exit(main())
