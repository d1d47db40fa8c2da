"""The port's server surface beyond text chat, over HTTP on the CPU, on
tiny random models: image chat (an OpenAI content array with a PNG data
URI) on a Moxin VLM, answered as the model's own ``chat`` answers, and
404 on a chat-only model; /v1/describe; /v1/ocr on an image and on a
one-page PDF, answered as the OCR model's ``ocr`` / ``ocr_pdf``; tool
calls parsed back into ``tool_calls`` on the engine path and on a
batcher; GET /v1/models/local and DELETE /v1/models/<name> on a
temporary model directory (``..`` refused); /v1/models/download 501;
``Server.load_model`` on a tiny Moxin and a tiny DeepSeek-OCR-2
checkpoint in HF names, each serving a describe / OCR request equal to
the in-memory model's; and ``python -m ominix_mlx_tpu_torch.generate`` on
a tiny checkpoint printing the text of the tokens ``Engine.generate``
gives."""

import base64
import io
import json
import os
import socket
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from ominix_mlx_tpu_torch.models import base, deepseek_ocr2, moxin_vlm
from ominix_mlx_tpu_torch.models import sam_vit
from ominix_mlx_tpu_torch.serving.server import ChatModel, Server
from ominix_mlx_tpu_torch.utils.loading import save_safetensors

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALL = ('<tool_call>{"name": "get_weather", "arguments": {"city": '
        '"Paris"}}</tool_call>')
TOOLS = [{"type": "function", "function": {
    "name": "get_weather", "parameters": {"type": "object"}}}]
CHAT_CFG = base.TransformerConfig(
    vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
    num_kv_heads=2, head_dim=16, intermediate_size=128, use_qk_norm=True,
    tie_word_embeddings=True)
OCR_LM = {"vocab_size": 129280, "hidden_size": 32, "num_hidden_layers": 2,
          "num_attention_heads": 2, "num_key_value_heads": 2,
          "intermediate_size": 64, "n_routed_experts": 8,
          "num_experts_per_tok": 2, "n_shared_experts": 1,
          "moe_intermediate_size": 16}
OCR_SAM = dict(img_size=128, patch_size=16, embed_dim=32, depth=2,
               num_heads=2, window_size=3, global_attn_indexes=(1,),
               out_chans=8, adapter_chans=16)


class ToolTokenizer:
    """UTF-8 bytes in; any answer decodes as one fixed tool call (so a
    random model's completion carries a call for the server to parse)."""
    eos_token_id = 511

    def encode(self, text):
        return list(text.encode("utf-8"))

    def decode(self, ids):
        return CALL if len(ids) else ""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _png(hw=(40, 52), seed=0) -> bytes:
    arr = np.random.default_rng(seed).integers(0, 256, hw + (3,), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "PNG")
    return buf.getvalue()


def _pdf(seed=1) -> bytes:
    """One page holding one embedded JPEG (as tests/test_vlm.py builds
    it)."""
    img = Image.fromarray(np.random.default_rng(seed).integers(
        0, 256, (64, 48, 3), np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="JPEG")
    jpeg = buf.getvalue()
    return (b"%PDF-1.4\n1 0 obj\n<< /Subtype /Image /Width 48 /Height 64 "
            b"/ColorSpace /DeviceRGB /BitsPerComponent 8 /Filter /DCTDecode "
            b"/Length " + str(len(jpeg)).encode() + b" >>\nstream\n"
            + jpeg + b"\nendstream\nendobj\n%%EOF")


def _b64(raw: bytes) -> str:
    return base64.b64encode(raw).decode()


def tiny_ocr(seed=0) -> deepseek_ocr2.DeepSeekOCR2:
    g = torch.Generator().manual_seed(seed)
    scfg = sam_vit.SamViTConfig(**OCR_SAM)
    fcfg = deepseek_ocr2.visual_flow_config(hidden=16, layers=1)
    flow = base.init_params(fcfg, g, torch.float32, "cpu")
    flow = {"layers": flow["layers"], "norm": flow["norm"],
            "query_768": torch.randn(4, 16, generator=g),
            "query_1024": torch.randn(9, 16, generator=g)}
    cfg = deepseek_ocr2.config_from_hf(OCR_LM)
    return deepseek_ocr2.DeepSeekOCR2(
        vision_params=sam_vit.init_params(scfg, g, device="cpu"),
        vision_cfg=scfg,
        projector={"w": torch.rand(32, 16, generator=g) - 0.5,
                   "b": torch.zeros(32)},
        lm_params=base.init_params(cfg, g, torch.float32, "cpu",
                                   dense_layers=1),
        lm_cfg=cfg, flow_params=flow, flow_cfg=fcfg,
        view_separator=torch.randn(32, generator=g) * 0.02, device="cpu")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = tmp_path_factory.mktemp("models")
    params = base.init_params(CHAT_CFG, torch.Generator().manual_seed(1),
                              torch.float32, device="cpu")
    srv = Server(port=_free_port(), models_root=str(root))
    srv.add_model("chat", ChatModel("chat", params, CHAT_CFG,
                                    ToolTokenizer(), "cpu",
                                    kv_dtype=torch.float32))
    srv.add_model("chat_batched", ChatModel(
        "chat_batched", params, CHAT_CFG, ToolTokenizer(), "cpu",
        kv_dtype=torch.float32))
    srv.enable_batching("chat_batched", slots=2, max_len=1024,
                        dtype=torch.float32)
    srv.add_model("vlm", moxin_vlm.init_tiny(torch.Generator().manual_seed(2),
                                             "cpu"))
    srv.add_model("ocr", tiny_ocr())
    srv.start_background()
    yield srv, root
    srv.shutdown()


def _url(srv, path):
    return f"http://127.0.0.1:{srv.port}{path}"


def _post(srv, path, body):
    req = urllib.request.Request(_url(srv, path),
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _code(fn, *a):
    with pytest.raises(urllib.error.HTTPError) as e:
        fn(*a)
    return e.value.code


def _image_messages(png):
    return [{"role": "user", "content": [
        {"type": "text", "text": "what is this?"},
        {"type": "image_url", "image_url": {
            "url": "data:image/png;base64," + _b64(png)}}]}]


def _arr(png):
    return np.asarray(Image.open(io.BytesIO(png)).convert("RGB"),
                      np.float32) / 255.0


def test_image_chat_on_a_vlm(served):
    srv, _ = served
    png = _png()
    out = _post(srv, "/v1/chat/completions",
                {"model": "vlm", "max_tokens": 5,
                 "messages": _image_messages(png)})
    text = out["choices"][0]["message"]["content"]
    assert text and text == srv.models["vlm"].chat("what is this?",
                                                   _arr(png), max_tokens=5)
    assert _code(_post, srv, "/v1/chat/completions",
                 {"model": "chat", "messages": _image_messages(png)}) == 404


def test_describe(served):
    srv, _ = served
    png = _png((28, 28), 3)
    out = _post(srv, "/v1/describe", {"model": "vlm", "image": _b64(png),
                                      "max_tokens": 6})
    want = srv.models["vlm"].chat("Describe this image in detail.",
                                  _arr(png), max_tokens=6)
    assert out["description"] == want
    assert out["tokens"] == len(want.split()) == 6
    assert out["tokens_per_second"] > 0
    assert _code(_post, srv, "/v1/describe",
                 {"model": "ocr", "image": _b64(png)}) == 404


def test_ocr_image_and_pdf(served):
    srv, _ = served
    m = srv.models["ocr"]
    png = _png((100, 90), 4)
    out = _post(srv, "/v1/ocr", {"image": _b64(png), "max_tokens": 4})
    assert out["text"] == m.ocr(_arr(png), max_tokens=4) != ""
    out = _post(srv, "/v1/ocr", {"pdf": _b64(_pdf()), "max_tokens": 4})
    assert out["pages"] == m.ocr_pdf(_pdf(), max_tokens=4)
    assert len(out["pages"]) == 1 and out["text"] == out["pages"][0]


@pytest.mark.parametrize("model", ["chat", "chat_batched"])
def test_tool_calls(served, model):
    """The engine path and a batcher: the completion's <tool_call> span
    comes back as an OpenAI tool call; tool_choice "none" leaves the
    content as it is."""
    srv, _ = served
    body = {"model": model, "max_tokens": 4, "tools": TOOLS,
            "messages": [{"role": "user", "content": "weather in Paris?"}]}
    out = _post(srv, "/v1/chat/completions", body)
    choice = out["choices"][0]
    assert choice["finish_reason"] == "tool_calls"
    assert choice["message"]["content"] is None
    (call,) = choice["message"]["tool_calls"]
    assert call["type"] == "function"
    assert call["function"]["name"] == "get_weather"
    assert json.loads(call["function"]["arguments"]) == {"city": "Paris"}
    out = _post(srv, "/v1/chat/completions", {**body, "tool_choice": "none"})
    assert out["choices"][0]["finish_reason"] == "stop"
    assert out["choices"][0]["message"]["content"] == CALL


def test_local_models_routes(served):
    srv, root = served
    os.makedirs(root / "org--tiny")
    (root / "org--tiny" / "config.json").write_text("{}")
    (root / "stray.txt").write_text("x")
    with urllib.request.urlopen(_url(srv, "/v1/models/local")) as r:
        data = json.loads(r.read())["data"]
    assert [(d["id"], d["has_config"]) for d in data] == [("org/tiny", True)]

    def delete(name):
        req = urllib.request.Request(_url(srv, "/v1/models/" + name),
                                     method="DELETE")
        with urllib.request.urlopen(req) as r:
            return json.loads(r.read())

    assert delete("..")["deleted"] is False
    assert delete("..%2Fmodels")["deleted"] is False
    assert os.path.isdir(root / "org--tiny")
    assert delete("org%2Ftiny") == {"deleted": True, "id": "org/tiny"}
    assert not os.path.exists(root / "org--tiny")
    assert (root / "stray.txt").exists()
    assert _code(_post, srv, "/v1/models/download",
                 {"repo_id": "org/tiny"}) == 501


# ------------------------------------------------- checkpoints on disk -----

def _vit_hf(p, cfg, dino: bool) -> dict:
    """A port ViT tree in HF Dinov2 / Siglip names."""
    out = {}
    if dino:
        out.update({
            "embeddings.patch_embeddings.projection.weight":
                p["patch_embed"]["w"],
            "embeddings.patch_embeddings.projection.bias":
                p["patch_embed"]["b"],
            "embeddings.cls_token": p["cls_token"],
            "embeddings.position_embeddings": p["pos_embed"],
            "embeddings.register_tokens": p["register_tokens"],
            "layernorm.weight": p["norm"]["w"],
            "layernorm.bias": p["norm"]["b"]})
        names = {"norm1": "norm1", "norm2": "norm2",
                 "q": "attention.attention.query",
                 "k": "attention.attention.key",
                 "v": "attention.attention.value",
                 "proj": "attention.output.dense", "fc1": "mlp.fc1",
                 "fc2": "mlp.fc2"}
        blk = "encoder.layer"
    else:
        out.update({
            "embeddings.patch_embedding.weight": p["patch_embed"]["w"],
            "embeddings.patch_embedding.bias": p["patch_embed"]["b"],
            "embeddings.position_embedding.weight": p["pos_embed"][0],
            "post_layernorm.weight": p["norm"]["w"],
            "post_layernorm.bias": p["norm"]["b"]})
        names = {"norm1": "layer_norm1", "norm2": "layer_norm2",
                 "q": "self_attn.q_proj", "k": "self_attn.k_proj",
                 "v": "self_attn.v_proj", "proj": "self_attn.out_proj",
                 "fc1": "mlp.fc1", "fc2": "mlp.fc2"}
        blk = "vision_model.encoder.layers"
        out = {"vision_model." + k: v for k, v in out.items()}
    for i, b in enumerate(p["blocks"]):
        for ours, hf in names.items():
            out[f"{blk}.{i}.{hf}.weight"] = b[ours]["w"]
            out[f"{blk}.{i}.{hf}.bias"] = b[ours]["b"]
        if "ls1" in b:
            out[f"{blk}.{i}.layer_scale1.lambda1"] = b["ls1"]
            out[f"{blk}.{i}.layer_scale2.lambda1"] = b["ls2"]
    return out


def _lm_hf(p, cfg) -> dict:
    """A port decoder tree (dense layers or MoE with a shared expert) in
    HF names."""
    out = {"model.embed_tokens.weight": p["embed"],
           "model.norm.weight": p["norm"]}
    if "lm_head" in p:
        out["lm_head.weight"] = p["lm_head"]["w"]
    for i, lp in enumerate(p["layers"]):
        pre = f"model.layers.{i}"
        out[f"{pre}.input_layernorm.weight"] = lp["input_layernorm"]
        out[f"{pre}.post_attention_layernorm.weight"] = \
            lp["post_attention_layernorm"]
        for n in ("q_proj", "k_proj", "v_proj", "o_proj"):
            out[f"{pre}.self_attn.{n}.weight"] = lp[n]["w"]
        if "moe" in lp:
            m = lp["moe"]
            out[f"{pre}.mlp.gate.weight"] = m["gate"]["w"]
            for n in ("gate_proj", "up_proj", "down_proj"):
                for e in range(m["experts"][n].shape[0]):
                    out[f"{pre}.mlp.experts.{e}.{n}.weight"] = \
                        m["experts"][n][e]
                out[f"{pre}.mlp.shared_experts.{n}.weight"] = \
                    m["shared_expert"][n]["w"]
        else:
            for n in ("gate_proj", "up_proj", "down_proj"):
                out[f"{pre}.mlp.{n}.weight"] = lp[n]["w"]
    return out


def _write(d, config, flat):
    os.makedirs(d)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(config, f)
    save_safetensors(os.path.join(d, "model.safetensors"),
                     {k: v.contiguous() for k, v in flat.items()})


def test_load_model_serves_vlm_and_ocr_checkpoints(tmp_path):
    import dataclasses

    vlm = moxin_vlm.init_tiny(torch.Generator().manual_seed(5), "cpu")
    flat = {**{"dino." + k: v for k, v in _vit_hf(
                vlm.dino_params, vlm.dino_cfg, True).items()},
            **{"siglip." + k: v for k, v in _vit_hf(
                vlm.siglip_params, vlm.siglip_cfg, False).items()},
            **{f"projector.{n}.{w}": vlm.projector[n][k]
               for n in ("fc1", "fc2", "fc3")
               for k, w in (("w", "weight"), ("b", "bias"))},
            **{"llm." + k: v for k, v in _lm_hf(vlm.lm_params,
                                                vlm.lm_cfg).items()}}
    lm = vlm.lm_cfg
    _write(str(tmp_path / "moxin"), {
        "model_type": "moxin_vlm",
        "text_config": {"model_type": "mistral",
                        "vocab_size": lm.vocab_size,
                        "hidden_size": lm.hidden_size,
                        "num_hidden_layers": lm.num_layers,
                        "num_attention_heads": lm.num_heads,
                        "num_key_value_heads": lm.num_kv_heads,
                        "head_dim": lm.head_dim,
                        "intermediate_size": lm.intermediate_size,
                        "tie_word_embeddings": True},
        "dino_config": dataclasses.asdict(vlm.dino_cfg),
        "siglip_config": dataclasses.asdict(vlm.siglip_cfg)}, flat)

    ocr = tiny_ocr(seed=6)
    sp = ocr.vision_params
    flat = {"model.sam_model.patch_embed.proj.weight": sp["patch_embed"]["w"],
            "model.sam_model.patch_embed.proj.bias": sp["patch_embed"]["b"],
            "model.sam_model.pos_embed": sp["pos_embed"]}
    for i, b in enumerate(sp["blocks"]):
        pre = f"model.sam_model.blocks.{i}"
        for ours, hf in (("norm1", "norm1"), ("norm2", "norm2"),
                         ("mlp_fc1", "mlp.lin1"), ("mlp_fc2", "mlp.lin2")):
            flat[f"{pre}.{hf}.weight"] = b[ours]["w"]
            flat[f"{pre}.{hf}.bias"] = b[ours]["b"]
        for n in ("qkv", "proj"):
            flat[f"{pre}.attn.{n}.weight"] = b["attn"][n]["w"]
            flat[f"{pre}.attn.{n}.bias"] = b["attn"][n]["b"]
        for n in ("rel_pos_h", "rel_pos_w"):
            flat[f"{pre}.attn.{n}"] = b["attn"][n]
    for i, n in enumerate(("neck0", "neck_ln0", "neck1", "neck_ln1")):
        for k, w in (("w", "weight"), ("b", "bias")):
            if k in sp[n]:
                flat[f"model.sam_model.neck.{i}.{w}"] = sp[n][k]
    for n in ("net2", "net3"):
        flat[f"model.sam_model.net_{n[-1]}.weight"] = sp[n]["w"]
        flat[f"model.sam_model.net_{n[-1]}.bias"] = sp[n]["b"]
    fp = ocr.flow_params
    for k, v in _lm_hf({"embed": torch.zeros(1), "norm": fp["norm"],
                        "layers": fp["layers"]}, ocr.flow_cfg).items():
        if k != "model.embed_tokens.weight":
            flat["model.qwen2_model.model." + k] = v
    for q in ("query_768", "query_1024"):
        flat[f"model.qwen2_model.{q}.weight"] = fp[q]
    flat["model.projector.layers.weight"] = ocr.projector["w"]
    flat["model.projector.layers.bias"] = ocr.projector["b"]
    flat["model.view_seperator"] = ocr.view_separator
    flat.update(_lm_hf(ocr.lm_params, ocr.lm_cfg))
    _write(str(tmp_path / "ocr2"), {
        "model_type": "deepseek_ocr2", **OCR_LM,
        "sam_config": dataclasses.asdict(ocr.vision_cfg),
        "flow_config": {"hidden": 16, "layers": 1}}, flat)

    srv = Server(port=_free_port())
    srv.load_model("moxin", str(tmp_path / "moxin"), device="cpu")
    srv.load_model("ocr2", str(tmp_path / "ocr2"), device="cpu")
    srv.start_background()
    try:
        png = _png((30, 30), 7)
        out = _post(srv, "/v1/describe", {"model": "moxin",
                                          "image": _b64(png),
                                          "max_tokens": 5})
        assert out["description"] == vlm.chat(
            "Describe this image in detail.", _arr(png), max_tokens=5)
        out = _post(srv, "/v1/ocr", {"model": "ocr2", "image": _b64(png),
                                     "max_tokens": 4})
        assert out["text"] == ocr.ocr(_arr(png), max_tokens=4)
        listed = {d["id"]: d["path"] for d in srv.list_models()["data"]}
        assert listed == {"moxin": str(tmp_path / "moxin"),
                          "ocr2": str(tmp_path / "ocr2")}
    finally:
        srv.shutdown()


# ------------------------------------------------------------- the CLI -----

def test_generate_command_line(tmp_path):
    """``python -m ominix_mlx_tpu_torch.generate --device cpu`` prints the
    text of the tokens Engine.generate gives on the same checkpoint (a
    bf16 cache, the fresh prefill, greedy)."""
    from tokenizers import Tokenizer as HFTokenizer
    from tokenizers.models import BPE
    from tokenizers.pre_tokenizers import Whitespace

    from ominix_mlx_tpu_torch.core.generate import Engine
    from ominix_mlx_tpu_torch.models import registry
    from ominix_mlx_tpu_torch.utils.tokenizer import Tokenizer

    cfg_json = {"model_type": "qwen3", "vocab_size": 64, "hidden_size": 32,
                "num_hidden_layers": 2, "num_attention_heads": 2,
                "num_key_value_heads": 1, "head_dim": 16,
                "intermediate_size": 48, "tie_word_embeddings": True}
    cfg = base.TransformerConfig.from_hf(cfg_json)
    params = base.init_params(cfg, torch.Generator().manual_seed(8),
                              torch.float32, "cpu")
    flat = _lm_hf(params, cfg)
    for i, lp in enumerate(params["layers"]):
        for n in ("q_norm", "k_norm"):
            flat[f"model.layers.{i}.self_attn.{n}.weight"] = lp[n]
    d = str(tmp_path / "tiny")
    _write(d, cfg_json, flat)
    vocab = {chr(97 + i): i for i in range(26)}
    vocab.update({"<eos>": 26, "hi": 27, "there": 28})
    tok = HFTokenizer(BPE(vocab=vocab, merges=[], unk_token=None))
    tok.pre_tokenizer = Whitespace()
    tok.save(os.path.join(d, "tokenizer.json"))
    with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
        json.dump({"eos_token": "<eos>"}, f)

    run = subprocess.run(
        [sys.executable, "-m", "ominix_mlx_tpu_torch.generate", "--model", d,
         "--prompt", "hi there", "--max-tokens", "12", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    mod, p, c = registry.load_model(d, device="cpu")
    tk = Tokenizer(d)
    ids = tk.encode("hi there")
    eng = Engine(lambda pp, t, cc: mod.forward(pp, c, t, cc), p,
                 prefill_forward_fn=lambda pp, t, cc: mod.forward(
                     pp, c, t, cc, fresh_prefill=True))
    toks = list(eng.generate(torch.tensor(ids), mod.init_cache(
        c, 1, len(ids) + 20, torch.bfloat16, "cpu"), 12,
        (tk.eos_token_id,)))
    assert toks
    assert run.stdout.rstrip("\n") == tk.decode(toks)
    assert "decode" in run.stderr
