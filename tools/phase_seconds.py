"""Run chip_smoke.py from each given checkout in turn and print the seconds
each run spent between the lines that end chip_smoke's phases.

    python tools/phase_seconds.py DIR [DIR ...] [--out artifacts/phase_seconds]

Give two checkouts as ``A B B A`` to compare them in turns on one card.
Every line a run prints is written, stamped with the seconds since that
run started, to ``<out>/<i>-<basename of DIR>.log``. Each segment ends at
the first line that matches its marker; a marker a run does not print
(an older checkout's missing phase) leaves its segment empty and the
next segment takes its time. Exits non-zero if any run does.
"""

import argparse
import os
import re
import subprocess
import sys
import time

# (segment, the line that ends it), in chip_smoke's order.
SEGMENTS = (
    ("build", r"^build: "),
    ("1-5 kernels", r"^flash fwd: device_ms "),
    ("6-7 engines", r"^engine bf16 kernel: decode tokens/s "),
    ("8 trainer f32", r"^trainer f32 B="),
    ("9 trainer bf16", r"^trainer bf16 B="),
    ("9b dispatch, fuse_steps", r"^attention dispatch bf16 \(9\)"),
    ("10-13 int8", r"^engine bf16 int8 \+ kv8 kernel: "),
    ("14 sampler, generate", r"^generate bf16 int8_decode "),
    ("15 front", r"^front faults: "),
    ("16", r"^phase 16 "),
    ("17", r"^phase 17 "),
    ("18", r"^phase 18 "),
    ("19", r"^phase 19 "),
    ("20", r"^phase 20 "),
    ("21", r"^phase 21 "),
    ("22", r"^phase 22 "),
    ("23", r"^phase 23 "),
    ("24", r"^phase 24 "),
    ("25", r"^phase 25 "),
    ("26", r"^phase 26 "),
    ("27", r"^phase 27 "),
    ("28", r"^phase 28 "),
    ("kernels line", r"^total: "),
)


def run_one(path: str, log_path: str) -> tuple[int, dict, float]:
    """One chip_smoke run: its exit code, each segment's end (seconds
    since the start) and its whole wall time."""
    ends = {}
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-u", "chip_smoke.py"], cwd=path,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            for line in proc.stdout:
                now = time.perf_counter() - t0
                log.write(f"{now:10.3f} {line}")
                for name, pattern in SEGMENTS:
                    if name not in ends and re.search(pattern, line):
                        ends[name] = now
            rc = proc.wait()
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return rc, ends, time.perf_counter() - t0


def segment_seconds(ends: dict, wall: float) -> dict:
    out, last = {}, 0.0
    for name, _ in SEGMENTS:
        if name in ends:
            out[name] = ends[name] - last
            last = ends[name]
    out["end"] = wall - last
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("dirs", nargs="+")
    p.add_argument("--out", default="artifacts/phase_seconds")
    args = p.parse_args()
    os.makedirs(args.out, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(card, flush=True)
    runs, failed = [], False
    for i, path in enumerate(args.dirs):
        label = f"{i}-{os.path.basename(os.path.abspath(path))}"
        rc, ends, wall = run_one(path, os.path.join(args.out, label + ".log"))
        failed |= rc != 0
        runs.append((label, segment_seconds(ends, wall)))
        print(f"{label}: exit {rc}, {wall:.1f} s", flush=True)
    names = [name for name, _ in SEGMENTS] + ["end"]
    print("segment (seconds) | " + " | ".join(label for label, _ in runs))
    for name in names:
        cells = [f"{seconds[name]:.1f}" if name in seconds else "-"
                 for _, seconds in runs]
        print(f"{name} | " + " | ".join(cells))
    print(card, flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
