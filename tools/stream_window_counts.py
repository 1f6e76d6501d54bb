#!/usr/bin/env python3
"""Executed-block counts of the streaming-window test, the reference's row
beside the port's copy, under the same load.

    python3 tools/stream_window_counts.py [runs] [burners]

Runs ``tests/test_data.py::test_streaming_window_bounds_inflight`` and
``tests/test_torch_data.py::test_streaming_window_bounds_inflight`` in
turns, ``runs`` times each (default 20; the first of each pair
alternates), each in a pytest process of its own, while ``burners``
processes (default 8) spin on the CPU.  A pytest
plugin, written to a temporary directory, records the number of marker
files each time the test lists its marker directory: the blocks that
had started when the first row came back (the test's bound is 16).
Prints each row's counts, its highest count, how many exceeded 16 and
how many runs failed.  Run it from the repository's root.
"""

import json
import os
import subprocess
import sys
import tempfile

PLUGIN = '''
import json
import os

_listdir = os.listdir


def _counting_listdir(path="."):
    out = _listdir(path)
    if "stream_markers" in str(path):
        with open(os.environ["STREAMCOUNT_OUT"], "a") as f:
            f.write(json.dumps(len(out)) + "\\n")
    return out


os.listdir = _counting_listdir
'''

ROWS = {"reference": "tests/test_data.py", "copy": "tests/test_torch_data.py"}


def main(runs: int, burners: int) -> None:
    tmp = tempfile.mkdtemp(prefix="stream-counts-")
    with open(os.path.join(tmp, "streamcount.py"), "w") as f:
        f.write(PLUGIN)
    spin = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
            for _ in range(burners)]
    counts = {k: [] for k in ROWS}
    failed = {k: 0 for k in ROWS}
    try:
        for i in range(runs):
            order = list(ROWS.items())
            for row, path in order[::-1] if i % 2 else order:
                out = os.path.join(tmp, row + ".jsonl")
                n = sum(1 for _ in open(out)) if os.path.exists(out) else 0
                env = dict(os.environ, STREAMCOUNT_OUT=out,
                           PYTHONPATH=tmp, JAX_PLATFORMS="cpu")
                rc = subprocess.run(
                    [sys.executable, "-m", "pytest", "-p", "streamcount",
                     "-p", "no:cacheprovider", "-q",
                     path + "::test_streaming_window_bounds_inflight"],
                    env=env, stdout=subprocess.DEVNULL,
                    stderr=subprocess.DEVNULL, timeout=300).returncode
                failed[row] += rc != 0
                with open(out) as f:
                    counts[row] += [json.loads(x) for x in f][n:]
    finally:
        for p in spin:
            p.kill()
            p.wait()
    for row in ROWS:
        c = counts[row]
        print(f"{row} ({ROWS[row]}): {c}; highest {max(c)}, over 16 in "
              f"{sum(x > 16 for x in c)} of {len(c)}, failed "
              f"{failed[row]} of {runs}")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 20,
         int(sys.argv[2]) if len(sys.argv) > 2 else 8)
