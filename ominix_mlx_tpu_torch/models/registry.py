"""One ``load_model(dir)`` for every family the port holds, dispatched on
the HF ``model_type`` of config.json (counterpart of
ominix_mlx_tpu/models/registry.py; ``MODEL_TYPES`` and the pipeline table
copied from there). ``load_pipeline`` loads the VLM (Moxin-7B), OCR
(DeepSeek-OCR-2), ASR (Paraformer, Fun-ASR-Nano and FunASR-Qwen4B,
Qwen3-ASR) and TTS (Qwen3-TTS) pipelines; the other pipeline types, and model types whose
family is not ported yet, raise ``NotImplementedError`` naming their
family."""

from __future__ import annotations

import importlib

from ominix_mlx_tpu_torch.utils.loading import load_config

_PKG = "ominix_mlx_tpu_torch.models."

# model_type -> its family's module (the JAX package's MODEL_TYPES)
MODEL_TYPES = {
    "qwen3": "qwen3",
    "qwen2": "qwen3",
    "mistral": "mistral",
    "glm4": "glm4",
    "glm": "glm4",
    "mixtral": "mixtral",
    "qwen3_moe": "qwen3_moe",
    "qwen2_moe": "qwen3_moe",
    "glm4_moe": "glm4_moe",
    "deepseek_v3": "deepseek_v3",
    "deepseek_v2": "deepseek_v3",
    "glm_47_flash": "deepseek_v3",
    "qwen3_next": "qwen3_next",
    "minicpm_sala": "minicpm_sala",
    "minicpm4": "minicpm_sala",
}
# the families of MODEL_TYPES this package holds
PORTED = {"qwen3", "qwen3_moe", "mistral", "glm4", "mixtral", "glm4_moe",
          "deepseek_v3", "qwen3_next", "minicpm_sala"}

# the JAX package's non-LLM families: model_type -> (its module there,
# capability)
PIPELINE_TYPES = {
    "paraformer": ("paraformer", "transcribe"),
    "funasr_nano": ("funasr_nano", "transcribe"),
    "funasr_qwen4b": ("funasr_nano", "transcribe"),
    "qwen3_asr": ("qwen3_asr", "transcribe"),
    "qwen3_tts": ("qwen3_tts", "speak"),
    "gpt_sovits": ("gpt_sovits", "clone"),
    "step_audio2": ("step_audio2", "speech2speech"),
    "flux_klein": ("flux_klein", "image"),
    "qwen_image": ("qwen_image", "image"),
    "zimage": ("zimage", "image"),
    "deepseek_ocr2": ("deepseek_ocr2", "ocr"),
    "deepseek_vl_v2": ("deepseek_ocr2", "ocr"),
    "moxin_vlm": ("moxin_vlm", "vlm"),
    "prismatic": ("moxin_vlm", "vlm"),
}
# the pipeline families this package holds
PORTED_PIPELINES = {"moxin_vlm", "deepseek_ocr2", "paraformer",
                    "funasr_nano", "qwen3_asr", "qwen3_tts"}


def capability(model_type: str) -> str:
    if model_type in MODEL_TYPES:
        return "chat"
    if model_type in PIPELINE_TYPES:
        return PIPELINE_TYPES[model_type][1]
    return "unknown"


def get_module(model_type: str):
    """The port's module for ``model_type``."""
    family = MODEL_TYPES.get(model_type)
    if family in PORTED:
        return importlib.import_module(_PKG + family)
    if family is not None:
        raise NotImplementedError(
            f"model_type {model_type!r}: the {family} family is not ported "
            f"to the torch package yet")
    if model_type in PIPELINE_TYPES:
        family, cap = PIPELINE_TYPES[model_type]
        if family in PORTED_PIPELINES:
            return importlib.import_module(_PKG + family)
        raise NotImplementedError(
            f"model_type {model_type!r}: the {family} pipeline ({cap}) is "
            f"not ported to the torch package yet")
    raise ValueError(f"unsupported model_type {model_type!r}; known: "
                     f"{sorted(MODEL_TYPES) + sorted(PIPELINE_TYPES)}")


def load_model(model_dir: str, device=None):
    """A chat checkpoint directory -> (module, params, config), the
    tensors on ``device`` (default: the current CUDA device; raises
    without a card). The module exposes ``forward`` and ``init_cache``.
    A pipeline directory raises: ValueError where its family is ported
    (``load_pipeline`` loads it), NotImplementedError where not."""
    mt = load_config(model_dir)["model_type"]
    mod = get_module(mt)
    if mt not in MODEL_TYPES:
        raise ValueError(f"{mt!r} is not a chat model; use load_pipeline")
    params, cfg = mod.load_model(model_dir, device=device)
    return mod, params, cfg


def load_pipeline(model_dir: str, device=None):
    """Any family -> (capability, object): a chat model as the triple of
    ``load_model``; a pipeline as its module's ``load_model`` gives it on
    ``device`` ("vlm": ``moxin_vlm.MoxinVLM``, "ocr":
    ``deepseek_ocr2.DeepSeekOCR2``, "transcribe": ``paraformer.
    Transcriber``, ``funasr_nano.FunASRNano`` or ``qwen3_asr.Qwen3ASR``,
    each with ``transcribe(samples, rate)``; "speak": ``qwen3_tts.
    TTSModel`` with ``synthesize(text, voice)``; the unported ones raise
    in ``get_module``)."""
    mt = load_config(model_dir)["model_type"]
    if mt in MODEL_TYPES:
        return "chat", load_model(model_dir, device)
    return capability(mt), get_module(mt).load_model(model_dir, device)
