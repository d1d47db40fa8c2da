"""From a checkpoint directory to served chat requests in the port: a
sharded checkpoint with a ``tokenizer.json`` (built as
tests/test_checkpoint_roundtrip.py builds one, with the JAX package's
writer) loaded by the port's ``registry.load_model(dir, device="cpu")``,
its logits equal to the JAX registry's on the same directory (float32,
1e-5; an MLX 4-bit checkpoint through both packages' dequantize-then-
product path, 1e-5 in float32 activations); ``Server.load_model`` then a
chat completion; the same for a random HF Mixtral, GLM-4-MoE,
DeepSeek-V3 and DeepSeek-V2 checkpoint (1e-4); the ``main()`` flags onto
``enable_batching``; and the model types and pipelines not ported raising
``NotImplementedError``."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ominix_mlx_tpu.core import quant as jquant
from ominix_mlx_tpu.models import base as jbase
from ominix_mlx_tpu.models import registry as jregistry
from ominix_mlx_tpu.utils.loading import save_safetensors
from ominix_mlx_tpu_torch.core.quant import QuantizedTensor
from ominix_mlx_tpu_torch.models import base as tbase
from ominix_mlx_tpu_torch.models import registry
from ominix_mlx_tpu_torch.serving import server as tserver
from ominix_mlx_tpu_torch.utils.tokenizer import ThinkFilter, Tokenizer

torch.set_num_threads(2)

CFG_JSON = {
    "model_type": "qwen3", "vocab_size": 64, "hidden_size": 32,
    "num_hidden_layers": 2, "num_attention_heads": 2,
    "num_key_value_heads": 1, "head_dim": 16, "intermediate_size": 64,
    "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
    "tie_word_embeddings": True,
}
TOKENS = [[1, 5, 9, 33, 2]]


def _hf_flat(params):
    """HF tensor names from a JAX tree (the inverse of params_from_flat)."""
    flat = {"model.embed_tokens.weight": params["embed"],
            "model.norm.weight": params["norm"]}
    for i, lp in enumerate(params["layers"]):
        p = f"model.layers.{i}"
        flat[f"{p}.input_layernorm.weight"] = lp["input_layernorm"]
        flat[f"{p}.post_attention_layernorm.weight"] = \
            lp["post_attention_layernorm"]
        for n in ("q_proj", "k_proj", "v_proj", "o_proj"):
            flat[f"{p}.self_attn.{n}.weight"] = lp[n]["w"]
        for n in ("gate_proj", "up_proj", "down_proj"):
            flat[f"{p}.mlp.{n}.weight"] = lp[n]["w"]
        flat[f"{p}.self_attn.q_norm.weight"] = lp["q_norm"]
        flat[f"{p}.self_attn.k_norm.weight"] = lp["k_norm"]
    return flat


def _write_tokenizer(d):
    from tokenizers import Tokenizer as HFTokenizer
    from tokenizers.models import BPE
    from tokenizers.pre_tokenizers import Whitespace

    vocab = {chr(97 + i): i for i in range(26)}
    vocab.update({"<eos>": 26, "hi": 27, "there": 28})
    tok = HFTokenizer(BPE(vocab=vocab, merges=[], unk_token=None))
    tok.pre_tokenizer = Whitespace()
    tok.save(os.path.join(d, "tokenizer.json"))
    with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
        json.dump({"eos_token": "<eos>",
                   "chat_template": "{% for m in messages %}{{ m['content'] }}"
                                    " {% endfor %}"}, f)


def _write_dir(d, flat, cfg_json):
    """Two shards and an index, config.json and a tokenizer."""
    os.makedirs(d)
    names = sorted(flat)
    half = len(names) // 2
    shards = {"model-00001-of-00002.safetensors": names[:half],
              "model-00002-of-00002.safetensors": names[half:]}
    for fname, group in shards.items():
        save_safetensors(os.path.join(d, fname), {k: flat[k] for k in group})
    with open(os.path.join(d, "model.safetensors.index.json"), "w") as f:
        json.dump({"weight_map": {k: fname for fname, group in shards.items()
                                  for k in group}}, f)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(cfg_json, f)
    _write_tokenizer(d)
    return d


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    cfg = jbase.TransformerConfig.from_hf(CFG_JSON)
    params = jbase.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    d = str(tmp_path_factory.mktemp("ckpt") / "tiny-qwen3")
    return _write_dir(d, _hf_flat(params), CFG_JSON)


def _both_logits(d):
    jmod, jp, jcfg = jregistry.load_model(d)
    jl, _ = jmod.forward(jp, jcfg, jnp.asarray(TOKENS),
                         jmod.init_cache(jcfg, 1, 16, jnp.float32))
    tmod, tp, tcfg = registry.load_model(d, device="cpu")
    with torch.inference_mode():
        tl, _ = tmod.forward(tp, tcfg, torch.tensor(TOKENS), tmod.init_cache(
            tcfg, 1, 16, torch.float32, device="cpu"))
    return np.asarray(jl), tl.numpy(), tp


def test_registry_load_equals_jax_registry(checkpoint):
    jl, tl, tp = _both_logits(checkpoint)
    assert tp["embed"].dtype == torch.float32
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)


def test_mlx_quantized_checkpoint_equals_jax_registry(checkpoint,
                                                      tmp_path):
    """Every projection stored in MLX's 4-bit layout (uint32 words, scales,
    biases; the embedding left float32 so the activations stay float32):
    the port loads plain QuantizedTensor weights whose logits equal the
    JAX package's."""
    cfg = jbase.TransformerConfig.from_hf(CFG_JSON)
    params = jbase.init_params(cfg, jax.random.PRNGKey(1), jnp.float32)
    qflat = {}
    for k, v in _hf_flat(params).items():
        if k.endswith("proj.weight"):
            packed, scales, biases = jquant.quantize(v, 16, 4)
            stem = k[: -len(".weight")]
            qflat[k] = packed
            qflat[stem + ".scales"] = scales
            qflat[stem + ".biases"] = biases
        else:
            qflat[k] = v
    d = _write_dir(str(tmp_path / "q4"), qflat, CFG_JSON | {
        "quantization": {"group_size": 16, "bits": 4}})
    jl, tl, tp = _both_logits(d)
    w = tp["layers"][0]["q_proj"]["w"]
    assert isinstance(w, QuantizedTensor) and w.bits == 4
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)


def test_tokenizer_and_server_load_model(checkpoint):
    from ominix_mlx_tpu.utils.tokenizer import Tokenizer as JTokenizer

    tok, jtok = Tokenizer(checkpoint), JTokenizer(checkpoint)
    ids = tok.encode("hi there", add_special_tokens=False)
    assert ids == jtok.encode("hi there", add_special_tokens=False)
    assert tok.decode(ids).replace(" ", "") == "hithere"
    assert tok.eos_token_id == jtok.eos_token_id == 26
    msgs = [{"role": "user", "content": "hi"}]
    assert tok.apply_chat_template(msgs) == jtok.apply_chat_template(msgs) \
        == "hi "
    srv = tserver.Server(port=0)
    try:
        m = srv.load_model("tiny", checkpoint, device="cpu")
        assert m.dir == checkpoint and m.device == torch.device("cpu")
        out = srv.chat_completion({
            "model": "tiny", "max_tokens": 4,
            "messages": [{"role": "user", "content": "hi there"}]})
        assert out["usage"]["prompt_tokens"] == len(tok.encode("hi there "))
        assert 1 <= out["usage"]["completion_tokens"] <= 4
        eng = m.engine(tserver.SamplerConfig())
        assert eng.chunk_forward_fn is not None \
            and eng.chunk_hidden_forward_fn is not None
    finally:
        srv.shutdown()


def test_think_filter_strips_spans_split_across_feeds():
    f = ThinkFilter()
    pieces = ["Hello <thi", "nk>secret</th", "ink> world", ""]
    assert "".join(f.feed(p) for p in pieces) == "Hello  world"


def test_main_flags_reach_enable_batching(checkpoint, monkeypatch):
    seen = {}
    monkeypatch.setattr(tserver.Server, "enable_batching",
                        lambda self, name, **kw: seen.update({name: kw}))
    args = tserver.parse_args([
        "--model", f"tiny={checkpoint}", "--port", "0", "--batch-slots",
        "3", "--batch-max-len", "256", "--batch-quantize-bits", "8",
        "--kv-bits", "8", "--batch-num-pages", "40", "--prefix-cache"])
    srv = tserver.build_server(args, device="cpu")
    try:
        assert set(srv.models) == {"tiny"}
        assert seen == {"tiny": dict(slots=3, max_len=256, quantize_bits=8,
                                     paged=True, num_pages=40, kv_bits=8,
                                     prefix_cache=True)}
    finally:
        srv.shutdown()
    args = tserver.parse_args(["--model", checkpoint])
    srv = tserver.build_server(args, device="cpu")
    try:
        assert set(srv.models) == {"tiny-qwen3"} and not seen.get(
            "tiny-qwen3")
    finally:
        srv.shutdown()


@pytest.fixture(scope="module")
def draft_checkpoint(tmp_path_factory):
    """A second tiny checkpoint: other weights, one layer, the same
    vocabulary."""
    cfg_json = dict(CFG_JSON, num_hidden_layers=1)
    params = jbase.init_params(jbase.TransformerConfig.from_hf(cfg_json),
                               jax.random.PRNGKey(5), jnp.float32)
    d = str(tmp_path_factory.mktemp("draft") / "tiny-draft")
    return _write_dir(d, _hf_flat(params), cfg_json)


@pytest.mark.parametrize("flag", [["--draft-model", "DRAFT"],
                                  ["--draft-layers", "2"]])
def test_main_draft_flags_raise(flag, checkpoint, draft_checkpoint):
    """``--draft-model DIR`` (a second checkpoint) and ``--draft-layers N``
    (a self-draft) turn on speculative decoding for the model, which
    serves plain greedy decoding's answer."""
    flag = [draft_checkpoint if f == "DRAFT" else f for f in flag]
    body = {"model": "tiny", "max_tokens": 8,
            "messages": [{"role": "user", "content": "hi there"}]}
    answers = []
    for extra in ([], flag):
        srv = tserver.build_server(tserver.parse_args(
            ["--model", f"tiny={checkpoint}", "--draft-tokens", "3",
             *extra]), device="cpu")
        try:
            assert bool(srv.spec) == bool(extra)
            answers.append(srv.chat_completion(dict(body)))
        finally:
            srv.shutdown()
    assert srv.spec["tiny"][2] == 3
    assert answers[1]["choices"] == answers[0]["choices"]
    assert answers[1]["usage"] == answers[0]["usage"]


@pytest.mark.parametrize("model_type,family", [
    ("step_audio2", "step_audio2"), ("qwen_image", "qwen_image"),
    ("flux_klein", "flux_klein"), ("gpt_sovits", "gpt_sovits"),
    ("zimage", "zimage")])
def test_unported_types_raise(model_type, family, tmp_path):
    with open(tmp_path / "config.json", "w") as f:
        json.dump({"model_type": model_type}, f)
    for load in (registry.load_model, registry.load_pipeline):
        with pytest.raises(NotImplementedError, match=family):
            load(str(tmp_path), device="cpu")
    assert registry.capability(model_type) == jregistry.capability(
        model_type)
    with pytest.raises(ValueError, match="unsupported"):
        registry.get_module("no_such_family")


@pytest.mark.parametrize("model_type,module", [
    ("paraformer", "paraformer"), ("funasr_nano", "funasr_nano"),
    ("funasr_qwen4b", "funasr_nano"), ("qwen3_asr", "qwen3_asr")])
def test_asr_types_load_with_the_port(model_type, module):
    """The ASR pipeline types load through the port's modules, each with a
    ``transcribe(samples, rate)`` facade (tests/test_torch_server_audio.py
    loads a checkpoint of each)."""
    mod = registry.get_module(model_type)
    assert mod.__name__ == f"ominix_mlx_tpu_torch.models.{module}"
    assert registry.capability(model_type) == "transcribe" \
        == jregistry.capability(model_type)
    assert callable(mod.load_model)


def test_tts_type_loads_with_the_port():
    """qwen3_tts loads through the port's module, a ``synthesize(text,
    voice)`` facade under capability "speak" (tests/test_torch_server_tts.py
    loads a checkpoint)."""
    mod = registry.get_module("qwen3_tts")
    assert mod.__name__ == "ominix_mlx_tpu_torch.models.qwen3_tts"
    assert registry.capability("qwen3_tts") == "speak" \
        == jregistry.capability("qwen3_tts")
    assert callable(mod.load_model) and hasattr(mod.TTSModel, "synthesize")


@pytest.mark.parametrize("model_type", ["minicpm_sala", "minicpm4"])
def test_minicpm_types_load_with_the_port(model_type):
    """Both MiniCPM-SALA model types load through the port's module
    (tests/test_torch_minicpm.py loads checkpoints of each)."""
    from ominix_mlx_tpu_torch.models import minicpm_sala

    assert registry.get_module(model_type) is minicpm_sala
    assert registry.capability(model_type) == "chat"


def test_registry_maps_every_jax_type():
    assert {mt: f"ominix_mlx_tpu.models.{fam}"
            for mt, fam in registry.MODEL_TYPES.items()} \
        == jregistry.MODEL_TYPES
    assert set(registry.PIPELINE_TYPES) == set(jregistry.PIPELINE_TYPES)
    for mt in ("qwen3", "qwen2", "qwen3_moe", "qwen2_moe", "mistral",
               "glm4", "glm"):
        assert registry.get_module(mt).load_model


def test_load_without_a_card_raises(checkpoint, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        registry.load_model(checkpoint)
    srv = tserver.Server(port=0)
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            srv.load_model("tiny", checkpoint)
    finally:
        srv.shutdown()


def test_loaded_glm4_tree_serves_fused_and_quantized(tmp_path):
    """A GLM-4 checkpoint in HF names through the port's own writer:
    ``quantize_params`` (4-bit, with the checkpoint's fused gate_up_proj)
    plus ``fuse_layer_projections`` serves a chat request."""
    from ominix_mlx_tpu_torch.utils.loading import save_sharded

    raw = {"model_type": "glm4", "vocab_size": 300, "hidden_size": 64,
           "num_hidden_layers": 2, "num_attention_heads": 4,
           "num_key_value_heads": 2, "head_dim": 16, "intermediate_size": 128,
           "partial_rotary_factor": 0.5, "attention_bias": True,
           "rms_norm_eps": 1e-5, "tie_word_embeddings": False}
    g = torch.Generator().manual_seed(0)
    flat = {"model.embed_tokens.weight": torch.randn(300, 64, generator=g),
            "model.norm.weight": torch.ones(64),
            "lm_head.weight": torch.randn(300, 64, generator=g) * 0.1}
    for i in range(2):
        p = f"model.layers.{i}"
        for n in ("input_layernorm", "post_attention_layernorm",
                  "post_self_attn_layernorm", "post_mlp_layernorm"):
            flat[f"{p}.{n}.weight"] = torch.ones(64)
        for n, shape in (("q_proj", (64, 64)), ("k_proj", (32, 64)),
                         ("v_proj", (32, 64)), ("o_proj", (64, 64))):
            flat[f"{p}.self_attn.{n}.weight"] = torch.randn(
                shape, generator=g) * 0.1
        for n in ("q_proj", "k_proj", "v_proj"):
            flat[f"{p}.self_attn.{n}.bias"] = torch.randn(
                flat[f"{p}.self_attn.{n}.weight"].shape[0], generator=g)
        flat[f"{p}.mlp.gate_up_proj.weight"] = torch.randn(
            256, 64, generator=g) * 0.1
        flat[f"{p}.mlp.down_proj.weight"] = torch.randn(
            64, 128, generator=g) * 0.1
    flat = {k: v.bfloat16() for k, v in flat.items()}
    d = tmp_path / "glm4"
    d.mkdir()
    save_sharded(str(d), flat)
    with open(d / "config.json", "w") as f:
        json.dump(raw, f)
    mod, params, cfg = registry.load_model(str(d), device="cpu")
    assert mod.__name__.endswith("glm4") and cfg.rope_traditional
    for k, got in (("model.layers.1.mlp.gate_up_proj.weight",
                    params["layers"][1]["gate_up_proj"]["w"]),
                   ("lm_head.weight", params["lm_head"]["w"])):
        assert torch.equal(got.view(torch.int16), flat[k].view(torch.int16))
    q = tbase.fuse_layer_projections(tbase.quantize_params(params, 64, 4))
    assert "gate_up_proj" in q["layers"][0] and "b" in q["layers"][0][
        "qkv_proj"]

    class Bytes:
        eos_token_id = 299

        def encode(self, text):
            return list(text.encode())

        def decode(self, ids):
            return bytes(i for i in ids if i < 256).decode("utf-8",
                                                           "replace")

    srv = tserver.Server(port=0)
    try:
        srv.add_model("glm", tserver.ChatModel("glm", q, cfg, Bytes(),
                                               "cpu", mod))
        out = srv.chat_completion({
            "model": "glm", "max_tokens": 3,
            "messages": [{"role": "user", "content": "hello"}]})
        assert out["usage"]["completion_tokens"] >= 1
    finally:
        srv.shutdown()


MOE_SMALL = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
                 num_attention_heads=2, intermediate_size=48,
                 tie_word_embeddings=False, pad_token_id=0)
MLA_SMALL = dict(MOE_SMALL, num_key_value_heads=2, moe_intermediate_size=16,
                 n_routed_experts=4, num_experts_per_tok=2,
                 n_shared_experts=1, first_k_dense_replace=1,
                 norm_topk_prob=True, routed_scaling_factor=1.5,
                 kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=8,
                 v_head_dim=8, head_dim=8, n_group=1, topk_group=1)


def _hf_model(model_type):
    """A random HF model of ``model_type`` and its flat float32 weights;
    a DeepSeek-V2 checkpoint gets the correction bias that the JAX
    package's loader reads for every DeepSeek model (it has none)."""
    import transformers as tf

    torch.manual_seed(0)
    if model_type == "mixtral":
        hf = tf.MixtralForCausalLM(tf.MixtralConfig(
            **MOE_SMALL, num_key_value_heads=1, num_local_experts=4,
            num_experts_per_tok=2))
    elif model_type == "glm4_moe":
        hf = tf.Glm4MoeForCausalLM(tf.Glm4MoeConfig(
            **MOE_SMALL, num_key_value_heads=1, head_dim=16,
            moe_intermediate_size=16, n_routed_experts=4,
            num_experts_per_tok=2, n_shared_experts=1,
            first_k_dense_replace=1, attention_bias=True))
    elif model_type == "deepseek_v3":
        hf = tf.DeepseekV3ForCausalLM(tf.DeepseekV3Config(
            **MLA_SMALL, q_lora_rank=16))
    else:
        hf = tf.DeepseekV2ForCausalLM(tf.DeepseekV2Config(
            **MLA_SMALL, q_lora_rank=None))
    flat = {k: jnp.asarray(v.detach().float().numpy())
            for k, v in hf.state_dict().items()}
    if model_type == "deepseek_v2":
        g = np.random.default_rng(0)
        flat["model.layers.1.mlp.gate.e_score_correction_bias"] = \
            jnp.asarray(g.standard_normal(4).astype(np.float32) * 0.1)
    return flat, hf.config.to_dict() | {"model_type": model_type}


@pytest.mark.parametrize("model_type", ["mixtral", "glm4_moe",
                                        "deepseek_v3", "deepseek_v2"])
def test_registry_loads_and_serves_moe_families(model_type, tmp_path):
    """A saved random HF checkpoint of each newly ported type through
    ``registry.load_model``: the family's module, dense experts stacked
    [E, N, K], logits within 1e-4 of the JAX registry's; then served
    through ``Server.load_model`` (a chat completion of up to 4 tokens)."""
    flat, cfg_json = _hf_model(model_type)
    d = _write_dir(str(tmp_path / model_type), flat, cfg_json)
    jl, tl, tp = _both_logits(d)
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
    mod, _, cfg = registry.load_model(d, device="cpu")
    assert mod.__name__.endswith(registry.MODEL_TYPES[model_type])
    assert (cfg.mla is not None) == model_type.startswith("deepseek")
    assert tp["layers"][1]["moe"]["experts"]["gate_proj"].dim() == 3
    srv = tserver.Server(port=0)
    try:
        srv.load_model("m", d, device="cpu")
        out = srv.chat_completion({
            "model": "m", "max_tokens": 4,
            "messages": [{"role": "user", "content": "hi there"}]})
        assert 1 <= out["usage"]["completion_tokens"] <= 4
    finally:
        srv.shutdown()
