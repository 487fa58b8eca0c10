"""Where ``chip_smoke.py``'s main thread spends its time.

    python -m repro_torch.testing.stack_sampler [--out PATH] [--every S]

Run from the root of a checkout, on a machine with a CUDA device: runs
``chip_smoke.main()`` while a thread samples the main thread's Python
stack every ``--every`` seconds (0.25 by default). Writes one JSON file
(``--out``, by default ``build/stack_sampler.json``): the samples, the
seconds under each function (inclusive, as ``file:function``), and for
each ``phase_*`` function of the script its seconds and its most common
innermost six frames. Time spent in C (a kernel launch, a copy, the
profiler's own parsing) counts to the Python frame that called it. The
sampler keeps no frame between samples, so it holds no object alive.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import threading


def _name(frame) -> str:
    return (f"{os.path.basename(frame.f_code.co_filename)}:"
            f"{frame.f_code.co_name}")


def run(out: str, every: float) -> None:
    sys.path.insert(0, os.getcwd())
    import chip_smoke

    main_id = threading.get_ident()
    stop = threading.Event()
    inclusive = collections.Counter()
    by_phase = collections.defaultdict(collections.Counter)
    phase_samples = collections.Counter()
    samples = 0

    def sample():
        nonlocal samples
        while not stop.wait(every):
            f = sys._current_frames().get(main_id)
            names, inner = [], []
            while f is not None:
                names.append(_name(f))
                if len(inner) < 6:
                    inner.append(f"{_name(f)}:{f.f_lineno}")
                f = f.f_back
            samples += 1
            inclusive.update(set(names))
            phase = next((n for n in reversed(names)
                          if n.startswith("chip_smoke.py:phase_")), "other")
            phase_samples[phase] += 1
            by_phase[phase][" < ".join(inner)] += 1

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    try:
        chip_smoke.main()
    finally:
        stop.set()
        sampler.join()
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as fh:
            json.dump({"every_s": every, "samples": samples,
                       "inclusive_s": [(k, c * every) for k, c in
                                       inclusive.most_common(150)],
                       "phases": {p: {"s": c * every,
                                      "top_s": [(k, n * every) for k, n in
                                                by_phase[p].most_common(25)]}
                                  for p, c in phase_samples.most_common()}},
                      fh, indent=0)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/stack_sampler.json")
    ap.add_argument("--every", type=float, default=0.25)
    args = ap.parse_args(argv)
    run(args.out, args.every)


if __name__ == "__main__":
    main()
