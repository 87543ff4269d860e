"""Batched LM serving through ``repro_torch``: prefill + decode with a KV
cache, on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/serve_lm_torch.py              # local loop
    PYTHONPATH=src python examples/serve_lm_torch.py --gateway    # over sockets
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu

``--gateway`` runs the same engine behind the repro_torch.gateway front-end
on an ephemeral loopback port, sends a few generate requests through the
retrying client, prints the served continuations, and drains gracefully.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse

from repro_torch.launch import serve


def gateway_demo(device: str):
    from repro_torch.gateway import EnginePump, GatewayClient, GatewayServer
    from repro_torch.serve.engine import LMServeEngine
    from repro_torch.serve.scheduler import SchedulerConfig

    engine = LMServeEngine(
        arch="starcoder2-7b", smoke=True,
        sched_config=SchedulerConfig(max_batch=4, max_queue=32),
        prefill=16, decode=8, device=device)
    engine.warmup()
    with GatewayServer({"generate": EnginePump(engine, "generate")}) as srv:
        client = GatewayClient(srv.url, timeout_s=120.0)
        print(f"[example] gateway up at {srv.url}; "
              f"health={client.health()['status']}")
        for prompt in ([1, 2, 3], [7, 8, 9, 10], [42]):
            out = client.generate(prompt, timeout_s=120.0)
            print(f"[example] prompt={prompt} -> continuation={out}")
        tokens = client.metrics()["generate"]["counters"]["tokens_generated"]
        print(f"[example] served {tokens} tokens over HTTP; draining")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--gateway", action="store_true")
    ap.add_argument("--device", default="cuda", help="device to serve on (cuda or cpu)")
    ap.add_argument("--requests", type=int, default=16)
    args = ap.parse_args(argv)
    if args.gateway:
        return gateway_demo(args.device)
    return serve.main(["--arch", "starcoder2-7b", "--requests", str(args.requests),
                       "--batch", "8", "--prefill", "64", "--decode", "32",
                       "--device", args.device])


if __name__ == "__main__":
    main()
