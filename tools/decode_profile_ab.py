"""The decode profile (``chip_smoke.py`` phase 4: a rung-8 step of the
full-width LM, 16 steps under the profiler) of two checkouts of this repo,
in turns, on the card.

    python3 tools/decode_profile_ab.py EARLIER_DIR CURRENT_DIR

runs ``phase_profile`` in a fresh process from each directory (its own
``chip_smoke.py``, ``mxnet_tpu_torch`` and kernel build), in the order
earlier, current, current, earlier, and prints each run's output: wall
and device-busy ms a step, the kernels that take the most device time and
their launches a step. Prints the card's name and power limit first.
"""
import subprocess
import sys

RUN = ("import numpy as np, chip_smoke as cs, mxnet_tpu_torch as mx; "
       "sym, params = cs._model(mx, np.random.RandomState(cs.SEED)); "
       "cs.phase_profile(mx, sym, params)")


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    earlier, current = sys.argv[1:3]
    for label, where in (("earlier", earlier), ("current", current),
                         ("current", current), ("earlier", earlier)):
        out = subprocess.run([sys.executable, "-c", RUN], cwd=where,
                             capture_output=True, text=True)
        print(f"--- {label} ({where}), exit {out.returncode}")
        print(out.stdout.strip() or out.stderr.strip()[-2000:])


if __name__ == "__main__":
    main()
