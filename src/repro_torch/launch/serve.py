"""Serving launcher: start the port's MAX REST stack (v1 + v2 surfaces).

    PYTHONPATH=src python -m repro_torch.launch.serve --port 8080 \
        --deploy qwen3-4b --full-width --max-seq 2048
    PYTHONPATH=src python -m repro_torch.launch.serve --port 8080 \
        --deploy recurrentgemma-9b --full-width --max-seq 4096

The flags are the JAX launcher's (``repro/launch/serve.py``), plus
``--device`` (default ``cuda``; the server raises at the first deploy
without a GPU unless ``--device cpu`` is given) and ``--full-width``
(build the published configuration instead of the reduced one).
``--service`` picks the execution strategy behind each deployment:
``sync`` (per request on the request thread), ``batched`` (continuous
batching) or ``auto`` (batched for every asset the port serves). QoS is
set per deploy, in the v2 deploy body's ``qos`` object.
"""

from __future__ import annotations

import argparse
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--deploy", action="append", default=[],
                    help="asset id to deploy at startup (repeatable)")
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--service", default="auto",
                    choices=["sync", "batched", "auto"],
                    help="inference service mode for deployments")
    ap.add_argument("--batch-window-ms", type=float, default=10.0,
                    help="coalescing window for the batched service")
    ap.add_argument("--duration", type=float, default=None,
                    help="serve for N seconds then exit (default: forever)")
    ap.add_argument("--device", default="cuda",
                    help="device the deployments build on")
    ap.add_argument("--full-width", action="store_true",
                    help="published widths instead of the reduced config")
    args = ap.parse_args()

    from repro_torch.core import EXCHANGE, MAXServer

    server = MAXServer(
        build_kw={"max_seq": args.max_seq, "max_batch": args.max_batch,
                  "device": args.device, "smoke": not args.full_width},
        service_mode=args.service,
        service_kw={"batch_window_s": args.batch_window_ms / 1e3},
        host=args.host, port=args.port)
    server.start()
    print(f"[serve] Model Asset eXchange (PyTorch) at {server.url}")
    print(f"[serve] {len(EXCHANGE)} assets registered; "
          f"GET /models, /v2/models, /v2/routes, /swagger.json")
    print(f"[serve] service mode: {args.service} "
          f"(window {args.batch_window_ms:.0f}ms), device {args.device}")
    try:
        for asset_id in args.deploy:
            t0 = time.perf_counter()
            dep = server.manager.deploy(asset_id, **server.build_kw)
            print(f"[serve] deployed {asset_id} [{dep.service.kind}] "
                  f"({time.perf_counter() - t0:.1f}s)")
        if args.duration:
            time.sleep(args.duration)
        else:
            while True:
                time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
        print("[serve] stopped")


if __name__ == "__main__":
    main()
