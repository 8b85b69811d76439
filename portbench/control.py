"""The control that the comparison has to fail: the reference, computed in
bfloat16 (the precision below the float32 that the configuration states
for penalties and similarities), put in the program's place at the cell's
own size:

    python portbench/control.py --workload <cell> --seeds 11 12 13

For each seed it prints the numbers ``compare`` reads for the control's
match set against the float32 reference's, each beside its limit. The
benchmark's own runs do not run it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import compare, manifest, reference, traffic  # noqa: E402
from portbench.run import problem_of  # noqa: E402


def control_rows(ctl: dict) -> list:
    """The control's match set as a search's output rows."""
    return [(q, s, e, sim, min(bds), sum(min(bds))) for (q, s, e), (sim, bds) in ctl.items()]


def control_checks(man, name: str, seed: int, device: str, scale: float = 1.0) -> dict:
    cell = man.cell(name)
    config = man.config(cell["config"])
    words = traffic.dictionary(config, seed)
    text = traffic.text(man.traffic(cell["traffic"]), words, seed, scale)
    prob = problem_of(config, words)
    ref = reference.match_set(prob, text, device)
    ctl = reference.match_set(prob, text, device, dtype=torch.bfloat16)
    got = compare.compare(control_rows(ctl), ref)
    got["matches"] = len(ref)
    return got


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    man = manifest.Manifest(ROOT)
    for seed in args.seeds:
        t = time.perf_counter()
        got = control_checks(man, args.workload, seed, "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed, "control": got,
                          "limits": compare.LIMITS, "seconds": time.perf_counter() - t}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
