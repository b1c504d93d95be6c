"""Train a model from an experiment configuration.

    python -m scd_resnet_tpu_torch.train <config.json>
        [--device cuda|cuda:N|cpu] [--backend nccl|gloo] [-debug]
    torchrun --nproc_per_node N -m scd_resnet_tpu_torch.train <config.json>

Counterpart of the root ``train.py`` (reference train.py:31-110). The
configuration has the ``exp.json`` schema (``configs/exp74.json`` is the
production centerOffsetRes10 run). It trains on the CUDA card unless
``--device cpu`` is given, and refuses to start without one. Results go
to ``dirResult`` (loss CSVs, ``evals.{trainName}.txt``,
``telemetry.{trainName}.jsonl``), checkpoints to ``dirTemp``; resume by
setting ``currentIter`` to a snapshot's iteration. cuDNN's settings follow
the configuration's ``precision`` for the run and are restored after it
(``core/device.training_backends``). ``-debug`` (or ``"debug": true`` in
the configuration) writes overlay PNGs of the last trained batch to
``dirResult/debug.{trainName}/`` at every validation boundary. The last
line of the standard output is the run's summary as one JSON object
(``NetworkFactory.begin_training``: steps, seconds, clips/s, the last
iteration and the kernel launches of the run).

Started by ``torchrun``, each rank joins the process group
(``parallel/mesh.init_distributed``: NCCL on cards, gloo on the CPU, or
``--backend gloo`` for ranks that share one card, which NCCL refuses)
and trains its part of the mesh that ``meshShape``/``meshAxes`` describe
(the data axis = the world size without them). ``--device cuda`` gives
rank r the cards ``cuda:{LOCAL_RANK x pipe + s}``; ``--device cuda:N``
pins every rank and pipeline stage to card N.
"""

from __future__ import annotations

import argparse
import json
import os
from pprint import pprint
from typing import Any, Dict, List, Optional

from scd_resnet_tpu_torch.core.compile_cache import enable_compilation_cache
from scd_resnet_tpu_torch.core.config import Configuration
from scd_resnet_tpu_torch.core.device import training_backends
from scd_resnet_tpu_torch.core.logging import Logger


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog="python -m scd_resnet_tpu_torch.train",
        description="train a model with a given configuration")
    parser.add_argument("configuration",
                        help="path to the configuration (exp.json schema)")
    parser.add_argument("--device", default="cuda",
                        help="cuda, cuda:N or cpu (default: the CUDA card; "
                        "under torchrun one card a rank)")
    parser.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                        help="torchrun's process-group backend (default: "
                        "nccl on cards, gloo on the CPU)")
    parser.add_argument("-debug", dest="debug", action="store_true",
                        help="write overlay PNGs of the last trained batch "
                        "at every validation boundary")
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Train as the command line says; returns the run's summary
    (``NetworkFactory.begin_training``)."""
    from scd_resnet_tpu_torch.parallel.mesh import init_distributed
    from scd_resnet_tpu_torch.train.factory import NetworkFactory

    args = parse_args(argv)
    enable_compilation_cache()
    init_distributed(args.device, args.backend)
    config = Configuration.from_json(args.configuration)
    if args.debug:
        config.update("debug", True)
    pprint(config.config, indent=4)
    Logger.info(":: train :: {} on {} ::".format(args.configuration,
                                                  args.device))
    with training_backends(config.config.get("precision", "float32")):
        factory = NetworkFactory(config, device=args.device)
        summary = factory.begin_training(telemetry_path=os.path.join(
            config.dirResult, "telemetry.{}.jsonl".format(config.trainName)))
    Logger.info(":: train :: done: {}".format(summary))
    if int(os.environ.get("RANK", "0")) == 0:
        print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
