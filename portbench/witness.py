"""How far a training cell's own precision puts the plain reference from
itself in float32: a witness for the limits of ``correct``.

    python3 portbench/witness.py --workload <name> --seeds 1 2 3 [--out FILE]

On the card, for each seed: the cell's pool, step-0 weights and first
three batches, as its driver makes them; the reference trains three
steps from them in float32 and again under ``torch.autocast`` in the
configuration's precision (its convolutions in bfloat16, BatchNorm and
the sums in the convolutions' dtype). One JSON line a seed: the autocast
run's ``compare.train`` numbers against the float32 run, and its
``head_gap`` (``drivers/train_heads.py``). Where they match the port's
readings, the port's distance from the reference is its precision's.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# the checkout's root, not this folder, on the path: the folder's module
# names (trace, inputs, ...) would shadow the standard library's
sys.path[:] = [str(ROOT)] + [p for p in sys.path
                             if Path(p or ".").resolve() != ROOT / "portbench"]

from portbench import harness  # noqa: E402


def readings(files, seed: int, device) -> dict:
    import torch

    from portbench import compare, inputs, weights
    from portbench.drivers import train, train_heads
    from portbench.reference import model as reference_model
    from portbench.reference import train as reference_train

    config, traffic = files["config"], files["traffic"]
    size, pool = traffic["clip"], traffic["pool"]
    samples, locs, counts = inputs.train_pool(
        pool, size, traffic["max_objects"], seed, device)
    feed = train.Feed(seed, pool, traffic["rows"] // pool, traffic["batch"],
                      size, device)
    batches = []
    for _ in range(train.COMPARED_STEPS):
        idx, draws = feed.next()
        rows = torch.from_numpy(idx % pool).to(device)
        batches.append({"samples": samples[rows], "locs": locs[rows],
                        "counts": counts[rows], "draws": draws})
    model = reference_model.build(config)
    weights.fill(model, config["weights"]["train"], seed, device)
    state = weights.state_dict(model)
    start = {k: v.detach().clone() for k, v in model.named_parameters()}
    del model
    dtype = getattr(torch, config["train"]["precision"])
    runs, heads = [], []
    for autocast in (False, True):
        model = reference_model.build(config)
        model.load_state_dict(state, strict=True)
        model.to(device)
        kept: dict = {}
        train_heads.keep_first(model, kept)
        with torch.autocast(device.type, dtype=dtype, enabled=autocast):
            runs.append(reference_train.run(model, batches, config,
                                            size // 4))
        heads.append(kept)
        del model
        if device.type == "cuda":
            torch.cuda.empty_cache()
    numbers = compare.train(runs[1], runs[0], start)
    numbers["head_gap"] = train_heads.head_gap(heads[1], heads[0])
    return numbers


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    import torch

    bench = harness.benchmark()
    files = harness.cell_files(bench, harness.cell(bench, args.workload))
    device = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        line = json.dumps({"workload": args.workload, "kind": "witness",
                           "precision": files["config"]["train"]["precision"],
                           "seed": seed,
                           "numbers": readings(files, seed, device)})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
