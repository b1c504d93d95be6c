"""Persistent whole-slide inference service on the PyTorch port.

Usage:
    python -m scd_resnet_tpu_torch.serve -c ckpt.pt -a cornerCPoolRes10 \
        [--device cuda|cpu] [--mesh] [--host 127.0.0.1] [--port 8600] \
        [--warmup 3092x2056] [--dedupe 16]

    curl -s -X POST --data-binary @slide.png \
        'http://127.0.0.1:8600/analyse?dedupe=16'
    curl -s http://127.0.0.1:8600/metrics

``-c`` takes a port checkpoint (``core/checkpoint.save_checkpoint``) or,
for ``centerOffset*`` profiles, a reference ``.pth``. The service runs
on CUDA unless ``--device cpu`` is given; without a GPU it refuses to
start. Convolutions and matmuls run in full float32 (TF32 off), the
precision of the JAX serve path, and cuDNN picks deterministic algorithms
so that the same slide always gives the same detections. ``--mesh``
shards each slide's clips over every visible CUDA device, one model copy
on each (the JAX ``serve.py --mesh``).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from scd_resnet_tpu_torch.core.device import (
    reproducible_float32,
    resolve_device,
    visible_cards,
)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="slide inference daemon (PyTorch port)")
    parser.add_argument("-c", dest="checkpoint", required=True,
                        help="port checkpoint, or reference .pth for "
                             "centerOffset* profiles")
    parser.add_argument("-a", dest="arch", default="centerOffsetRes10",
                        help="model profile")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8600)
    parser.add_argument("--dedupe", type=float, default=None,
                        help="default tile-overlap suppression radius (px)")
    parser.add_argument("--mesh", action="store_true",
                        help="shard each slide's clips over every visible "
                        "CUDA device")
    parser.add_argument("--warmup", action="append", default=[],
                        metavar="WxH", help="prepare this slide geometry at "
                        "startup (repeatable), e.g. --warmup 3092x2056")
    args = parser.parse_args(argv)
    if args.mesh and args.device != "cuda":
        parser.error("--mesh shards over the CUDA devices; it excludes "
                     "--device cpu")
    return args


def build_service(args: argparse.Namespace):
    """The configured ``InferenceService`` (raises without CUDA unless
    ``--device cpu``)."""
    from scd_resnet_tpu_torch.infer.server import InferenceService
    from scd_resnet_tpu_torch.infer.wrapper import load_wrapper

    device = resolve_device(args.device)
    reproducible_float32()
    print(":: serve :: TF32 off for cuDNN and cuBLAS (float32 as the JAX "
          "serve path); deterministic cuDNN algorithms", flush=True)
    wrapper = load_wrapper(args.checkpoint, args.arch, device)
    mesh = visible_cards() if args.mesh else None
    if mesh is not None:
        print(":: serve :: sharding clip batches over {} device(s)".format(
            len(mesh)), flush=True)
    service = InferenceService(wrapper, dedupe_radius=args.dedupe, mesh=mesh)
    print(":: serve :: serving {} as {} on {}".format(
        args.checkpoint, args.arch, device), flush=True)
    for geom in args.warmup:
        width, height = (int(v) for v in geom.lower().split("x"))
        seconds = service.warmup(width, height)
        print(":: serve :: warmed up {}x{} in {:.1f}s".format(
            width, height, seconds), flush=True)
    return service


def main(argv: Optional[Sequence[str]] = None) -> None:
    from scd_resnet_tpu_torch.core.compile_cache import (
        enable_compilation_cache,
    )
    from scd_resnet_tpu_torch.infer.server import create_server

    args = parse_args(argv)
    enable_compilation_cache()
    service = build_service(args)
    server = create_server(service, args.host, args.port)
    print(":: serve :: listening on http://{}:{}".format(
        args.host, server.server_address[1]), flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print(":: serve :: shutting down", flush=True)
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
