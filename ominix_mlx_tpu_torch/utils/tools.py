"""OpenAI-style tool calling over the <tool_call> XML convention (copied
from ominix_mlx_tpu/utils/tools.py, stdlib only; importing that module
would load jax through the JAX package's ``__init__``).

The GLM/Qwen model families are trained to receive function signatures in a
``# Tools`` system block (JSON signatures inside <tools></tools>) and to emit
calls as ``<tool_call>{"name": ..., "arguments": {...}}</tool_call>`` spans
(reference behavior: glm-4.7-flash-mlx/examples/tool_use.py builds exactly
this block and parses the same XML; the Qwen3 chat template ships the same
wire format). This module renders the request side and parses the response
side so /v1/chat/completions can speak the OpenAI ``tools`` / ``tool_calls``
contract with any such model.
"""

from __future__ import annotations

import json
import re
import uuid
from typing import List, Optional, Tuple

_CALL_RE = re.compile(r"<tool_call>\s*(\{.*?\})\s*</tool_call>", re.S)


def tools_system_block(tools: List[dict]) -> str:
    """Render the tools system block for a request's ``tools`` array."""
    sigs = "\n".join(json.dumps(t, ensure_ascii=False) for t in tools)
    return (
        "# Tools\n\n"
        "You may call one or more functions to assist with the user query.\n"
        "\n"
        "You are provided with function signatures within <tools></tools> "
        "XML tags:\n"
        f"<tools>\n{sigs}\n</tools>\n\n"
        "For each function call, return a json object with function name "
        "and arguments within <tool_call></tool_call> XML tags:\n"
        "<tool_call>\n"
        '{"name": <function-name>, "arguments": <args-json-object>}\n'
        "</tool_call>")


def inject_tools(messages: List[dict], tools: List[dict]) -> List[dict]:
    """Return a copy of `messages` with the tools block folded into the
    system turn (appended to an existing one, else prepended)."""
    msgs = [dict(m) for m in messages]
    block = tools_system_block(tools)
    if msgs and msgs[0].get("role") == "system":
        base = msgs[0].get("content") or ""
        msgs[0]["content"] = f"{base}\n\n{block}" if base else block
    else:
        msgs.insert(0, {"role": "system", "content": block})
    return msgs


def parse_tool_calls(text: str) -> Tuple[str, List[dict]]:
    """Split generated text into (content, OpenAI tool_calls list).

    Well-formed <tool_call> JSON spans become
    ``{"id", "type": "function", "function": {"name", "arguments"}}``
    entries (arguments re-serialized as a JSON string, the OpenAI wire
    shape); malformed spans stay in the content untouched.
    """
    calls: List[dict] = []

    def _sub(mt: "re.Match[str]") -> str:
        try:
            obj = json.loads(mt.group(1))
        except json.JSONDecodeError:
            return mt.group(0)
        if not isinstance(obj, dict) or "name" not in obj:
            return mt.group(0)
        args = obj.get("arguments", {})
        calls.append({
            "id": f"call_{uuid.uuid4().hex[:12]}",
            "type": "function",
            "function": {
                "name": str(obj["name"]),
                "arguments": json.dumps(args, ensure_ascii=False),
            },
        })
        return ""

    content = _CALL_RE.sub(_sub, text).strip()
    return content, calls


def finalize_tool_response(resp: dict, tools: Optional[List[dict]]) -> dict:
    """Post-process a chat.completion response: when the request carried
    tools and the model emitted <tool_call> spans, surface them as OpenAI
    ``tool_calls`` with finish_reason="tool_calls"."""
    if not tools:
        return resp
    for choice in resp.get("choices", ()):
        msg = choice.get("message") or {}
        content, calls = parse_tool_calls(msg.get("content") or "")
        if calls:
            msg["content"] = content or None
            msg["tool_calls"] = calls
            choice["finish_reason"] = "tool_calls"
    return resp
