"""A checkpoint's [It] line, offline: no training.

    python -m scd_resnet_tpu_torch.tools.eval_checkpoint <exp.json> <ckpt>
        [--device cuda|cuda:N|cpu]

Counterpart of the root ``tools/eval_checkpoint.py``. Builds the
trainer (``train/factory.NetworkFactory``) from the experiment
configuration, loads the checkpoint's weights and BatchNorm statistics
(the port's checkpoint, the JAX package's msgpack checkpoint or, for
``centerOffset*``, a reference ``.pth``; ``core/checkpoint.
load_state_dict``), runs the trainer's validation pass over the
configuration's validation set, in its precision and batches, and prints
the family's [It] line. It runs on the CUDA card unless ``--device cpu``
is given.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

from scd_resnet_tpu_torch.core.compile_cache import enable_compilation_cache
from scd_resnet_tpu_torch.core.config import Configuration
from scd_resnet_tpu_torch.core.device import training_backends
from scd_resnet_tpu_torch.core.logging import Logger


def main(argv: Optional[List[str]] = None) -> str:
    """Evaluate as the command line says; returns the [It] line it
    prints."""
    from scd_resnet_tpu_torch.train.factory import NetworkFactory

    parser = argparse.ArgumentParser(
        prog="python -m scd_resnet_tpu_torch.tools.eval_checkpoint",
        description="the [It] line of a checkpoint on a configuration's "
                    "validation set")
    parser.add_argument("config", help="experiment configuration (exp.json)")
    parser.add_argument("checkpoint", help="the port's, the JAX package's "
                        "or a reference checkpoint")
    parser.add_argument("--device", default="cuda",
                        help="cuda, cuda:N or cpu (default: the CUDA card)")
    args = parser.parse_args(argv)
    if not os.path.exists(args.checkpoint):
        parser.error("checkpoint does not exist: {}".format(args.checkpoint))

    enable_compilation_cache()
    cfg = Configuration.from_json(args.config)
    with training_backends(cfg.config.get("precision", "float32")):
        factory = NetworkFactory(cfg, device=args.device)
        factory.load_pretrained(args.checkpoint)
        Logger.log("evaluating {} on the {} validation set".format(
            os.path.basename(args.checkpoint), cfg.datasetName))
        line = "[It] " + factory.validation_expression()
    print(line, flush=True)
    return line


if __name__ == "__main__":
    main()
