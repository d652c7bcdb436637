"""Serving launcher of the port: continuous-batching paged serving with the
quantized KV cache, the counterpart of the JAX package's
``launch/serve.py`` (same arguments, same output lines).

Usage (the smoke config on the CPU; on the card drop ``--device cpu``):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b --smoke \\
      --device cpu --requests 16 --slots 4 --max-new 24
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b --async-runtime

The weights are random, from a seeded ``torch.Generator``.  ``--device``
picks where the engine runs (the card unless ``cpu``).  ``--async-runtime``
runs the overlapped runtime: each decode step is one replay of a captured
CUDA graph, and the host reads a step's tokens up to ``--async-window``
steps after dispatching it (``repro_torch.serve.async_runtime``).
``--spec-k K`` (K > 1) decodes by self-speculation: K - 1 greedy drafts a
cycle read the same pools at ``--spec-bits`` bits, one verify pass keeps
the longest prefix the full-fidelity argmax agrees with (on the card each
pass is one CUDA graph replay); the streams equal ``--spec-k 1``.

Page-pool sizing, reservations, preemption, the auditor, deadlines,
``--strict``, ``--metrics-every`` and tracing (``--trace-out``) work as in
the JAX launcher.  ``--family`` serves attention (llama3-8b), MLA
(deepseek-v3-671b), the Mamba2 hybrid (zamba2-7b: exact-length prefill
groups, no prefix sharing) and the recurrent xLSTM family (xlstm-1.3b,
through the exact-length shim: no pool, each prompt prefilled alone).
``--dense`` forces the shim for any family (a dense decode state; for
attention the dense quantized cache and its kernels).  ``--arch
seamless-m4t-medium`` (the encoder-decoder) and ``--arch qwen2-vl-7b`` (the
VLM stub) reach the engine's ``ValueError``, as in the JAX launcher: their
prefill needs frame or patch embeddings that a request does not carry.
``--splitkv`` goes to the engine as in the JAX launcher, which builds no
mesh either: without one every step is unsplit (a mesh and page-affine
pools are ``ServeEngine`` arguments, ``repro_torch.launch.mesh`` builds the
meshes).
"""
from __future__ import annotations

import argparse
import pathlib

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.core.device import resolve_device
from repro_torch.models.zoo import build_model
from repro_torch.serve.engine import Request, ServeEngine

FAMILY_ARCHS = {
    "attn": "llama3-8b",
    "mla": "deepseek-v3-671b",
    "hybrid": "zamba2-7b",
    "xlstm": "xlstm-1.3b",
}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None, help="explicit architecture (overrides --family)")
    ap.add_argument("--family", choices=sorted(FAMILY_ARCHS), default=None,
                    help="serve a representative arch of this cache family")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="where the engine runs: the card unless 'cpu'")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=512)
    ap.add_argument("--kv-bits", type=int, default=4)
    ap.add_argument("--pages", type=int, default=None,
                    help="page-pool size (default: fully provisioned)")
    ap.add_argument("--dense", action="store_true",
                    help="force the exact-length shim (dense decode state)")
    ap.add_argument("--splitkv", choices=("auto", "always", "never"), default="auto",
                    help="cross-chip split-KV routing policy")
    ap.add_argument("--shared-prefix-len", type=int, default=0,
                    help="give every prompt a common template prefix of this many tokens "
                         "so the prefix index reuses resident pages")
    ap.add_argument("--no-prefix-sharing", action="store_true",
                    help="disable the scheduler's prompt-prefix index")
    ap.add_argument("--reserve-policy", choices=("worst_case", "expected"),
                    default="worst_case",
                    help="admission reservation: full lifetime worst case, or a quantile "
                         "of the remaining decode budget (backed by preemption)")
    ap.add_argument("--expected-quantile", type=float, default=0.5,
                    help="decode-budget quantile reserved under --reserve-policy expected")
    ap.add_argument("--preempt-policy", choices=("youngest", "fewest_pages"),
                    default="youngest",
                    help="victim selection when the pool runs dry mid-decode")
    ap.add_argument("--audit-every", type=int, default=0,
                    help="run the invariant auditor every N engine cycles (0 disables)")
    ap.add_argument("--spec-k", type=int, default=1,
                    help="self-speculative decode depth (> 1 enables)")
    ap.add_argument("--spec-bits", type=int, default=None,
                    help="draft-path read precision in bits")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request TTL on the engine clock; overdue requests retire "
                         "as EXPIRED")
    ap.add_argument("--strict", action="store_true",
                    help="raise on unadmittable submissions instead of retiring them "
                         "as REJECTED")
    ap.add_argument("--async-runtime", action="store_true",
                    help="overlapped decode runtime: each decode step one CUDA graph "
                         "replay, no per-cycle host sync, a background completion thread; "
                         "bit for bit equal to the sync cycle")
    ap.add_argument("--async-window", type=int, default=2, metavar="W",
                    help="in-flight decode steps before the host consumes the oldest")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome trace_event JSON here plus a .jsonl sibling "
                         "with the raw events")
    ap.add_argument("--metrics-every", type=int, default=0, metavar="N",
                    help="print the Prometheus text exposition of the metrics registry "
                         "every N engine cycles (0 off)")
    return ap


def main(argv=None):
    ap = _parser()
    args = ap.parse_args(argv)
    if args.arch is None:
        if args.family is None:
            ap.error("one of --arch / --family is required")
        args.arch = FAMILY_ARCHS[args.family]

    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = cfg.with_(kv_bits=args.kv_bits)
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen, dev)
    engine = ServeEngine(
        model, params, slots=args.slots, max_seq=args.max_seq,
        paged=False if args.dense else None, n_pages=args.pages, splitkv=args.splitkv,
        share_prefix=not args.no_prefix_sharing, reserve_policy=args.reserve_policy,
        expected_quantile=args.expected_quantile, preempt_policy=args.preempt_policy,
        audit_every=args.audit_every, strict=args.strict, spec_k=args.spec_k,
        spec_bits=args.spec_bits, metrics_every=args.metrics_every,
        async_runtime=args.async_runtime, async_window=args.async_window,
        trace=args.trace_out is not None, device=dev,
    )
    print(f"[serve] engine mode: {'paged' if engine.paged else 'exact-length shim'}"
          + (f", pool={engine.n_pages} pages ({engine.kv_page_bytes} B/page)"
             if engine.paged else ""))

    rng = np.random.default_rng(0)
    sharing_demo = engine.paged and not args.no_prefix_sharing and args.shared_prefix_len > 0
    shared_len = min(args.shared_prefix_len, args.prompt_len)
    prefix = rng.integers(0, cfg.vocab, shared_len).astype(np.int32)
    try:
        for uid in range(args.requests):
            tail = rng.integers(0, cfg.vocab, args.prompt_len - shared_len).astype(np.int32)
            # sharing demo: staggered completions keep live donors in the index
            engine.submit(Request(
                uid=uid, prompt=np.concatenate([prefix, tail]),
                max_new_tokens=args.max_new + (uid % 3 if sharing_demo else 0),
                deadline_s=args.deadline_s,
            ))
        stats = engine.run()
    finally:
        engine.close()
    print(f"[serve] {stats}")
    phase = stats.get("phase_s", {})
    cyc = phase.get("cycle", 0.0)
    print("[serve] latency: "
          f"ttft_p50={stats['ttft_p50_ms']:.2f}ms"
          f" ttft_p99={stats['ttft_p99_ms']:.2f}ms"
          f" tpot_p50={stats['tpot_p50_ms']:.3f}ms"
          f" tpot_p99={stats['tpot_p99_ms']:.3f}ms"
          f" queue_wait_p50={stats['queue_wait_p50_ms']:.2f}ms")
    breakdown = " ".join(
        f"{k}={v:.3f}s({v / cyc:.0%})" if cyc > 0 else f"{k}={v:.3f}s"
        for k, v in sorted(phase.items()) if k != "cycle")
    print(f"[serve] phases: cycle={cyc:.3f}s {breakdown} "
          f"host_stall={stats['host_stall_fraction']:.1%}")
    if stats.get("preempted"):
        print(f"[serve] pressure: preempted={stats['preempted']}"
              f" preempt_remat_tokens={stats['preempt_remat_tokens']}"
              f" audits={stats['audits']}")
    if args.spec_k > 1:
        print(f"[serve] speculative: k={args.spec_k}"
              f" accept_rate={stats.get('spec_accept_rate', 0.0):.3f}"
              f" drafted={stats.get('spec_draft_tokens', 0)}"
              f" accepted={stats.get('spec_accepted_tokens', 0)}"
              f" draft_replays={engine._draft.replays}"
              f" verify_replays={engine._verify.replays}")
    if engine._runner is not None:
        step = engine._runner.step_fn
        print(f"[serve] async runtime: window={engine._runner.window}"
              f" dispatched={engine._runner.dispatched}"
              f" discarded_steps={stats['discarded_steps']}"
              f" graph_replays={step.replays if step.graph is not None else 0}"
              f" launches={step.launches}")
    if engine.paged and not args.no_prefix_sharing:
        print(f"[serve] prefix sharing: hit_rate={stats['prefix_hit_rate']:.3f}"
              f" prefill_tokens_saved={stats['prefill_tokens_saved']}"
              f" cow_copies={stats['cow_copies']}")
    if args.trace_out is not None:
        out = pathlib.Path(args.trace_out)
        engine.tracer.write_chrome(out)
        jsonl = out.with_suffix(".jsonl")
        engine.tracer.write_jsonl(jsonl)
        print(f"[serve] trace: {len(engine.tracer.events)} events -> {out} "
              f"(Chrome trace_event; open in Perfetto), raw -> {jsonl}")
    return stats


if __name__ == "__main__":
    main()
