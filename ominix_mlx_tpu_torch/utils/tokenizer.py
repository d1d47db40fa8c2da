"""Tokenizer and chat templating (copied from
ominix_mlx_tpu/utils/tokenizer.py: ``Tokenizer``, ``chatml`` and
``ThinkFilter``; importing that module would load jax through the JAX
package's ``__init__``).

``Tokenizer(model_dir)`` reads the directory's ``tokenizer.json`` with the
HF ``tokenizers`` runtime, imported when a Tokenizer is built (a missing
package raises ``ImportError`` naming it), and renders the chat template
of ``tokenizer_config.json`` in a Jinja sandbox, with ChatML where there
is none or it fails.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional


class Tokenizer:
    def __init__(self, model_dir: str):
        try:
            from tokenizers import Tokenizer as HFTokenizer
        except ImportError as e:
            raise ImportError(
                "Tokenizer needs the HF 'tokenizers' package to read "
                f"{os.path.join(model_dir, 'tokenizer.json')}") from e

        self._tok = HFTokenizer.from_file(
            os.path.join(model_dir, "tokenizer.json"))
        self.config = {}
        cfg_path = os.path.join(model_dir, "tokenizer_config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                self.config = json.load(f)
        self.eos_token = self.config.get("eos_token")
        if isinstance(self.eos_token, dict):
            self.eos_token = self.eos_token.get("content")
        self.eos_token_id = (self._tok.token_to_id(self.eos_token)
                             if self.eos_token else None)
        self.chat_template = self.config.get("chat_template")

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        return self._tok.encode(text,
                                add_special_tokens=add_special_tokens).ids

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        return self._tok.decode(list(map(int, ids)),
                                skip_special_tokens=skip_special_tokens)

    def token_to_id(self, token: str) -> Optional[int]:
        return self._tok.token_to_id(token)

    def apply_chat_template(self, messages: List[dict],
                            add_generation_prompt: bool = True) -> str:
        """The model's Jinja chat template, rendered in a sandbox (the
        template comes from a checkpoint's tokenizer_config.json, so it
        never sees the full Jinja environment); ChatML where there is no
        template, or jinja2 is missing, or the template fails."""
        if self.chat_template:
            try:
                from jinja2.sandbox import ImmutableSandboxedEnvironment

                env = ImmutableSandboxedEnvironment()
                env.globals["raise_exception"] = _raise
                tpl = env.from_string(self.chat_template)
                return tpl.render(
                    messages=messages,
                    add_generation_prompt=add_generation_prompt,
                    bos_token=self.config.get("bos_token") or "",
                    eos_token=self.eos_token or "")
            except Exception:
                pass
        return chatml(messages, add_generation_prompt)


def _raise(msg):
    raise ValueError(msg)


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


class ThinkFilter:
    """Strip <think>...</think> spans from streamed text."""

    def __init__(self):
        self._in_think = False
        self._buf = ""

    def feed(self, text: str) -> str:
        self._buf += text
        out = []
        while self._buf:
            if self._in_think:
                end = self._buf.find("</think>")
                if end < 0:
                    # keep a tail in case the close tag is split
                    self._buf = self._buf[-8:]
                    break
                self._buf = self._buf[end + len("</think>"):]
                self._in_think = False
            else:
                start = self._buf.find("<think>")
                if start < 0:
                    safe = self._buf if len(self._buf) < 7 else self._buf[:-7]
                    if "<think"[: len(self._buf)] == self._buf:
                        break
                    out.append(safe)
                    self._buf = self._buf[len(safe):]
                    break
                out.append(self._buf[:start])
                self._buf = self._buf[start + len("<think>"):]
                self._in_think = True
        return "".join(out)
