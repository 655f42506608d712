#!/usr/bin/env python3
"""chip_smoke.py's own ``main`` stopped once phase 7 has reported.

    python3 tools/smoke_phase7.py [TREE]

Runs ``chip_smoke.main()`` of the checkout at TREE (default: this file's
repository) -- nvidia-smi, the kernels' build, then phase 7 over every
visible card, as the whole smoke runs them -- and ends with exit 0 when
the next phase starts (``kernel_phase`` is replaced by a function that
raises), so a four-card machine (``--chips 4``) runs phase 7 in the
order and the process state of the whole run for a fraction of its time.
Prints no result line. Every process dumps its stack every 450 s, before
the ranks' 300 s collectives time out a second time.
"""
import faulthandler
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
tree = os.path.abspath(sys.argv[1] if __name__ == "__main__" and len(sys.argv) > 1
                       else os.environ.get("SMOKE_TREE", HERE))
os.environ["SMOKE_TREE"] = tree  # the spawned ranks import this file as __mp_main__ and read it
sys.path[:0] = [os.path.join(tree, "src"), tree]
faulthandler.dump_traceback_later(450, repeat=True)
import chip_smoke as cs  # noqa: E402


class _Stop(Exception):
    pass


def _stop(*args, **kwargs):
    raise _Stop


if __name__ == "__main__":
    os.chdir(tree)
    sys.argv = [os.path.join(tree, "chip_smoke.py")]
    cs.kernel_phase = _stop  # the phase after phase 7
    t = time.perf_counter()
    try:
        cs.main()
    except _Stop:
        print(f"phase 7 done: the build and phase 7 as chip_smoke.main runs them, {time.perf_counter() - t:.1f} s",
              flush=True)
        sys.exit(0)
    sys.exit(1)
