"""Readings for the limits of ``correct``: in one process, for each
seed, one short run of a cell (set-up, a window of ``--seconds``, the
same sample and comparison as a run) and the control's readings on the
same refits: the reference with its solve in the traffic's
``control`` precision (float32 below the f64 fit) put in the port's
place. Prints one JSON line per seed and the largest sound and smallest
control reading of each number. Not run by the benchmark's runs.

    python3 portbench/calibrate.py --workload <cell> --seconds 3 --seeds 101 102 ...
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import check, run  # noqa: E402
from portbench.spec import Spec  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run.cache_env()
    spec = Spec(ROOT)
    sound, control = {}, {}
    for seed in args.seeds:
        result, rows, _, st = run.run_cell(spec, args.workload, seed,
                                           args.seconds, False,
                                           device=args.device)
        traffic = spec.traffic(spec.cell(args.workload)["traffic"])
        ctrl = check.control(st.records, st.refs, st.names, st.sample,
                             st.maxiter, traffic["control"], st.device)
        line = {"seed": seed, "correct": result["correct"],
                "attempted": result["attempted"], "failed": result["failed"],
                "sound": st.numbers, "control": ctrl}
        print(json.dumps(line), flush=True)
        for k, v in st.numbers.items():
            sound[k] = max(sound.get(k, v), v)
        for k, v in ctrl.items():
            control[k] = min(control.get(k, v), v)
    print(json.dumps({"workload": args.workload, "seeds": len(args.seeds),
                      "sound_max": sound, "control_min": control}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
