"""Multi-replica serving demo: a Router fleet multiplexing one Engram pool
through a single shared hot-row cache, with streamed and cancelled
requests — the full request-lifecycle surface on a tiny config.

This doubles as the CI serve-smoke: it exercises submit/step/stream/
cancel/drain, the shared-cache hit path across replicas, and the private-
cache baseline comparison, and fails loudly if any of it regresses.
PyTorch port of ``examples/serve_router.py``: the fleet runs on the card
unless ``--device cpu`` says otherwise.

    PYTHONPATH=src python -m repro_torch.examples.serve_router [--fast]
"""
import argparse
import dataclasses
import sys

from repro_torch.launch.serve import with_store
from repro_torch.launch.train import reduced_config
from repro_torch.serving import Router, Workload


def tiny_cfg():
    cfg = reduced_config("deepseek-7b")
    cfg = dataclasses.replace(cfg, n_layers=3, layer_types=("attn",) * 3,
                              attn_kinds=("global",) * 3,
                              ffn_types=("dense",) * 3,
                              engram=dataclasses.replace(cfg.engram,
                                                         layers=(1,)))
    return with_store(cfg, cache_rows=50_000)


def run_fleet(cfg, workload, *, shared: bool, cancel: int = 0,
              stream_first: bool = False, device=None):
    router = Router(cfg, replicas=2, pool="RDMA", policy="round_robin",
                    shared_cache=shared, max_batch=2, max_len=64,
                    prompt_bucket=8, device=device)
    handles = [router.submit(list(s.prompt), s.max_new)
               for s in workload.build(cfg.vocab_size)]
    if stream_first and handles:
        toks = list(handles[0].stream())     # steps its replica as needed
        print(f"  streamed request {handles[0].rid}: {toks}")
        assert toks == handles[0].tokens and handles[0].finished
    if cancel:
        # cancel the last `cancel` still-pending requests mid-flight
        pending = [h for h in handles if not h.finished]
        for h in pending[-cancel:]:
            assert h.cancel(), f"cancel({h.rid}) failed"
    router.drain()
    for h in handles:
        assert h.finished or h.cancelled, (h.rid, h.status)
    return router, handles


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="the CUDA card unless this says otherwise (cpu)")
    args = ap.parse_args(argv)
    n = args.requests if args.requests is not None \
        else (6 if args.fast else 10)
    cfg = tiny_cfg()
    # shared-prompt traffic (3 hot prompts): the regime where one cache
    # across replicas pays — replica B hits rows replica A fetched
    wl = Workload(requests=n, max_new=4, prompt_pool=3)

    print("router x2 (shared cache), streamed + cancelled requests:")
    router, handles = run_fleet(cfg, wl, shared=True, stream_first=True,
                                cancel=1, device=args.device)
    rs = router.stats()
    cancelled = [h.rid for h in handles if h.cancelled]
    print(f"  fleet: {rs.aggregate.generated_tokens} tokens, "
          f"{rs.aggregate.requests_completed} completed, "
          f"cancelled {cancelled}")
    for name, st in rs.per_replica.items():
        print(f"  {name}: {st.generated_tokens} tokens, "
              f"{st.prefills} prefills")
    shared_hit = rs.cache.hit_rate
    print(f"  shared-cache hit_rate={shared_hit:.3f} "
          f"({rs.cache.hits}/{rs.cache.hits + rs.cache.misses})")
    assert rs.aggregate.requests_cancelled == len(cancelled) == 1

    router2, _ = run_fleet(cfg, wl, shared=False, device=args.device)
    stores = router2.store_stats()
    hits = sum(s.hits for s in stores.values())
    total = sum(s.hits + s.misses for s in stores.values())
    private_hit = hits / max(total, 1)
    print(f"router x2 (private caches) hit_rate={private_hit:.3f}")
    assert shared_hit > private_hit, (shared_hit, private_hit)
    print(f"shared cache beats private: "
          f"{shared_hit:.3f} > {private_hit:.3f}  OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
