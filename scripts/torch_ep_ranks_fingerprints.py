#!/usr/bin/env python3
"""``chip_smoke.py``'s ``[ep ranks]`` for one or more trees, with each
run's fingerprint errors by parameter.

    python3 scripts/torch_ep_ranks_fingerprints.py ROOT [ROOT ...]

Each ROOT is a checkout of the repository (another commit unpacked with
``git archive`` under the git-ignored ``build/``, or a copy with
``EP_RANKS_SEED`` edited in its ``chip_smoke.py`` to read another draw of
the weights).  For each root, in the order given, runs that tree's
``phase_ep_reference()`` and ``phase_ep_ranks()`` (4 gloo ranks on the card
and 4 on the CPU) with their checks reported instead of raised, and prints
the ``[ep ranks]`` lines and, for each fingerprint compared ((a) and (b):
the first step's gradients, then the parameters' change), the four
parameters with the largest relative error.  Needs a CUDA device; about 3
minutes a root.
"""

from __future__ import annotations

import os
import subprocess
import sys

_RUN = r'''
import json
import chip_smoke as cs

tops = []
err = cs._fingerprint_err


def by_parameter(got, want):
    worst = {}
    for name, sums in want.items():
        for g, w in zip(got[name], sums):
            diff, scale = (g - w).norm().item(), w.norm().item()
            worst[name] = max(worst.get(name, 0.0), diff / scale if scale else 0.0)
    tops.append(sorted(worst.items(), key=lambda kv: -kv[1])[:4])
    return err(got, want)


cs._fingerprint_err = by_parameter
cs._check = lambda ok, what: ok or print("CHECK", what)
cs.phase_ep_ranks(cs.phase_ep_reference())
print("EP_RANKS_SEED", cs.EP_RANKS_SEED)
for top in tops:
    print("TOP", json.dumps(top))
'''


def main(roots) -> int:
    for root in roots:
        root = os.path.abspath(root)
        print("=== root", root, flush=True)
        run = subprocess.run([sys.executable, "-c", _RUN], cwd=root,
                             env=dict(os.environ, PYTHONPATH=root), capture_output=True,
                             text=True, timeout=900)
        keep = ("[ep ranks]", "TOP", "EP_RANKS", "CHECK", "Traceback", "RuntimeError")
        print("\n".join(line for line in (run.stdout + run.stderr).splitlines()
                        if line.startswith(keep)), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1:]))
