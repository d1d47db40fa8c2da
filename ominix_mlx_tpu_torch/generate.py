"""Text generation from the command line (the port's counterpart of
examples/generate.py, with its flags, and ``--device``):

    python -m ominix_mlx_tpu_torch.generate --model DIR --prompt "Hello" \\
        --max-tokens 256 [--temperature 0.7] [--quantize q8] [--chat] \\
        [--draft-model DIR --draft-tokens 4] [--device cpu]

The checkpoint directory loads through ``models.registry.load_model`` with
its ``tokenizer.json``; ``--quantize`` quantizes the weights on the fly
(group 64, 4 or 8 bits) and fuses the projections; the text streams from
``Engine.generate`` (every ten tokens, as the reference example), or with
``--draft-model`` from a speculative engine's greedy rounds. Statistics
go to standard error. The model runs on the current CUDA device unless
``--device`` names another.
"""

from __future__ import annotations

import argparse
import inspect
import sys
import time

import torch


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="generate text from a checkpoint directory")
    ap.add_argument("--model", required=True, help="HF checkpoint dir")
    ap.add_argument("--prompt", default="Hello")
    ap.add_argument("--max-tokens", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--quantize", choices=["none", "q4", "q8"],
                    default="none",
                    help="on-the-fly weight quantization, group size 64")
    ap.add_argument("--chat", action="store_true",
                    help="wrap the prompt with the model's chat template")
    ap.add_argument("--draft-model", default=None,
                    help="small same-vocabulary checkpoint for speculative "
                         "decoding (greedy)")
    ap.add_argument("--draft-tokens", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    from ominix_mlx_tpu_torch.core.device import resolve_device
    from ominix_mlx_tpu_torch.core.generate import Engine, GenerationStats
    from ominix_mlx_tpu_torch.core.sampling import SamplerConfig
    from ominix_mlx_tpu_torch.models import base, registry
    from ominix_mlx_tpu_torch.utils.tokenizer import Tokenizer

    args = parse_args(argv)
    device = resolve_device(args.device)
    mod, params, cfg = registry.load_model(args.model, device=device)
    if args.quantize != "none":
        params = base.fuse_layer_projections(base.quantize_params(
            params, 64, 4 if args.quantize == "q4" else 8))
    tok = Tokenizer(args.model)
    text = (tok.apply_chat_template([{"role": "user",
                                      "content": args.prompt}])
            if args.chat else args.prompt)
    ids = torch.tensor(tok.encode(text), dtype=torch.long, device=device)
    stops = (tok.eos_token_id,) if tok.eos_token_id is not None else ()

    if args.draft_model:
        from ominix_mlx_tpu_torch.core.speculative import (SpecStats,
                                                          SpeculativeEngine)

        dmod, dparams, dcfg = registry.load_model(args.draft_model,
                                                  device=device)
        spec = SpeculativeEngine(
            lambda p, t, c: mod.forward(p, cfg, t, c), params,
            lambda p, t, c: dmod.forward(p, dcfg, t, c), dparams,
            num_draft_tokens=args.draft_tokens)
        cap = len(ids) + args.max_tokens + 2 * args.draft_tokens + 8
        st = SpecStats()
        t0 = time.perf_counter()
        out = list(spec.generate(
            ids, mod.init_cache(cfg, 1, cap, torch.bfloat16, device),
            dmod.init_cache(dcfg, 1, cap, torch.bfloat16, device),
            max_tokens=args.max_tokens, stop_tokens=stops, stats=st))
        dt = time.perf_counter() - t0
        print(tok.decode(out), flush=True)
        print(f"\n-- speculative: {len(out)} tok in {dt:.2f}s "
              f"({len(out) / dt:.1f} tok/s), acceptance "
              f"{st.acceptance_rate:.2f}", file=sys.stderr)
        return 0

    kw = {}
    if "fresh_prefill" in inspect.signature(mod.forward).parameters:
        kw["prefill_forward_fn"] = lambda p, t, c: mod.forward(
            p, cfg, t, c, fresh_prefill=True)
    engine = Engine(lambda p, t, c: mod.forward(p, cfg, t, c), params,
                    SamplerConfig(temperature=args.temperature,
                                  top_k=args.top_k, top_p=args.top_p), **kw)
    cache = mod.init_cache(cfg, 1, len(ids) + args.max_tokens + 8,
                           torch.bfloat16, device)
    stats = GenerationStats()
    out, printed = [], ""
    for t in engine.generate(ids, cache, args.max_tokens, stops,
                             stats=stats):
        out.append(t)
        if len(out) % 10 == 0:
            full = tok.decode(out)
            print(full[len(printed):], end="", flush=True)
            printed = full
    print(tok.decode(out)[len(printed):], flush=True)
    print(f"\n-- prefill {stats.prompt_tokens} tok "
          f"({stats.prefill_tps:.0f} tok/s); decode {stats.generated_tokens} "
          f"tok ({stats.decode_tps:.1f} tok/s)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
