"""Chat prompt formatting (copied from ominix_mlx_tpu/utils/tokenizer.py:74,
``chatml``: importing that module would load jax through the JAX
package's ``__init__``)."""

from __future__ import annotations

import json
from typing import List


def chatml(messages: List[dict], add_generation_prompt: bool = True) -> str:
    """ChatML prompt format. Tool observations (role="tool") render as
    <tool_response> spans inside a user turn; assistant messages carrying
    ``tool_calls`` re-emit their <tool_call> JSON spans."""
    out = []
    for m in messages:
        role = m["role"]
        if role == "tool":
            out.append("<|im_start|>user\n<tool_response>\n"
                       f"{m.get('content') or ''}\n"
                       "</tool_response><|im_end|>\n")
            continue
        content = m.get("content") or ""
        if role == "assistant" and m.get("tool_calls"):
            spans = []
            for call in m["tool_calls"]:
                fn = call.get("function", {})
                args = fn.get("arguments", {})
                if isinstance(args, str):
                    try:
                        args = json.loads(args)
                    except json.JSONDecodeError:
                        pass
                spans.append(
                    "<tool_call>\n" + json.dumps(
                        {"name": fn.get("name", ""), "arguments": args},
                        ensure_ascii=False) + "\n</tool_call>")
            content = (content + "\n" if content else "") + "\n".join(spans)
        out.append(f"<|im_start|>{role}\n{content}<|im_end|>\n")
    if add_generation_prompt:
        out.append("<|im_start|>assistant\n")
    return "".join(out)
