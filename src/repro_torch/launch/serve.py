"""Serving launcher: Dodoor-routed batched inference over a replica fleet —
the port of ``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --requests 2000 --qps 40 [--policy dodoor|pot|random|prequal] \
        [--decode-demo] [--device cuda|cpu]

Runs the request trace for the chosen arch through the fleet simulation
(the same engine as the paper reproduction — replicas are bins; the
sequential oracle, the reference's default mode), prints the serving
metrics, and demos the online router API plus one real decode on the smoke
model so the whole path (router → model.decode_step) is exercised.  It runs
on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

import torch

from ..configs import ARCHS
from ..models import registry
from ..serving import DodoorRouter, make_replica_pool, synthesize_requests
from ..sim import EngineConfig, simulate, summarize


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--requests", type=int, default=2000)
    ap.add_argument("--qps", type=float, default=40.0)
    ap.add_argument("--policy", default=None,
                    help="one policy; default compares all")
    ap.add_argument("--decode-demo", action="store_true",
                    help="run a real greedy decode on the smoke model")
    ap.add_argument("--device", default="cuda",
                    help="where the simulation, router and model run")
    args = ap.parse_args(argv)

    cfg = ARCHS[args.arch]
    pool = make_replica_pool()
    trace = synthesize_requests(cfg, args.requests, args.qps)
    print(f"fleet: {pool.num_servers} replicas × {pool.type_names}; "
          f"arch={cfg.name}; {args.requests} requests @ {args.qps} qps")

    policies = [args.policy] if args.policy else \
        ["random", "pot", "prequal", "dodoor"]
    for pol in policies:
        res = simulate(trace, pool, EngineConfig(
            policy=pol, b=max(1, pool.num_servers // 2)),
            mode="sequential", device=args.device)
        print(summarize(res).row())

    # Online router API demo (gateway-side placement).
    router = DodoorRouter(pool, device=args.device)
    for i in range(8):
        j = router.place(cfg, prompt_len=1024, gen_len=128)
        print(f"request {i} → replica {j} "
              f"({pool.type_names[pool.node_type[j]]})")

    if args.decode_demo:
        smoke = cfg.smoke()
        params = registry.init_params(smoke, 0, device=args.device)
        cache = registry.init_cache(smoke, 1, 32, dtype=torch.float32,
                                    device=args.device)
        tok = torch.zeros((1, 1), dtype=torch.long, device=args.device)
        out = []
        for _ in range(16):
            logits, cache = registry.decode_step(smoke, params, cache, tok)
            tok = logits[:, -1:].argmax(-1)
            out.append(int(tok[0, 0]))
        print("greedy decode (smoke model):", out)


if __name__ == "__main__":
    main()
