"""Shared pieces of the port's text-tower tests: tiny HF Qwen2.5-VL and CLIP
models (the configs of ``tests/test_text_encoders.py``), their weights in
both packages, and tiny word-level tokenizers built and saved with no
download."""

import os
import re

import numpy as np
import torch

import jax.numpy as jnp

from kandinsky5_tpu.checkpoint import convert_clip_state_dict as jax_convert_clip
from kandinsky5_tpu.checkpoint import convert_qwen_state_dict as jax_convert_qwen
from kandinsky5_tpu.text.clip import ClipTextConfig as JaxClipConfig
from kandinsky5_tpu.text.qwen import QwenTextConfig as JaxQwenConfig
from kandinsky5_tpu_torch.checkpoint import clip_from_state_dict, qwen_from_state_dict
from kandinsky5_tpu_torch.text.clip import ClipTextConfig
from kandinsky5_tpu_torch.text.embedder import EXPAND_INSTRUCTION, PROMPT_TEMPLATE
from kandinsky5_tpu_torch.text.qwen import QwenTextConfig

QWEN_KW = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, head_dim=16, rms_norm_eps=1e-6,
               rope_theta=1000000.0)
CLIP_KW = dict(vocab_size=99, hidden_size=32, intermediate_size=64,
               num_hidden_layers=2, num_attention_heads=4)
# the tiny CLIP tokenizer's end-of-text id: the largest, as in ViT-L/14
CLIP_EOT = 98


def hf_qwen(seed=0):
    """A tiny random HF Qwen2.5-VL (vision tower included) in eval mode."""
    from transformers import Qwen2_5_VLForConditionalGeneration
    from transformers.models.qwen2_5_vl.configuration_qwen2_5_vl import (
        Qwen2_5_VLConfig,
    )

    cfg = Qwen2_5_VLConfig(
        text_config=dict(
            vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, hidden_act="silu",
            max_position_embeddings=512, rms_norm_eps=1e-6,
            rope_theta=1000000.0, tie_word_embeddings=False,
            rope_scaling={"type": "mrope", "mrope_section": [2, 3, 3]},
        ),
        vision_config=dict(
            depth=1, hidden_size=32, intermediate_size=32, num_heads=2,
            in_channels=3, patch_size=14, spatial_merge_size=2,
            temporal_patch_size=2, out_hidden_size=64,
            fullatt_block_indexes=[],
        ),
    )
    torch.manual_seed(seed)
    return Qwen2_5_VLForConditionalGeneration(cfg).eval()


def hf_clip(eos_token_id=2, seed=0):
    from transformers import CLIPTextConfig, CLIPTextModel

    cfg = CLIPTextConfig(max_position_embeddings=77, hidden_act="quick_gelu",
                         eos_token_id=eos_token_id, **CLIP_KW)
    torch.manual_seed(seed)
    return CLIPTextModel(cfg).eval()


def state_dict_np(model):
    return {k: v.detach().float().numpy() for k, v in model.state_dict().items()}


def qwen_pair(hf_model):
    """The HF model's weights as a JAX pytree and as the port's tower (fp32,
    CPU), both through their package's converter."""
    sd = state_dict_np(hf_model)
    jax_params = jax_convert_qwen(sd, dtype=jnp.float32)
    model = qwen_from_state_dict(sd, QwenTextConfig(**QWEN_KW), device="cpu",
                                 dtype=torch.float32)
    return JaxQwenConfig(**QWEN_KW), jax_params, model


def clip_pair(hf_model, eos_token_id=2):
    sd = state_dict_np(hf_model)
    jax_params = jax_convert_clip(sd, dtype=jnp.float32)
    model = clip_from_state_dict(sd, ClipTextConfig(eos_token_id=eos_token_id,
                                                    **CLIP_KW),
                                 device="cpu", dtype=torch.float32)
    return (JaxClipConfig(eos_token_id=eos_token_id, **CLIP_KW), jax_params,
            model)


CHAT_TEMPLATE = (
    "{% for m in messages %}<|im_start|>{{ m['role'] }}\n"
    "{% if m['content'] is string %}{{ m['content'] }}{% else %}"
    "{% for c in m['content'] %}{{ c['text'] }}{% endfor %}{% endif %}"
    "<|im_end|>\n{% endfor %}"
    "{% if add_generation_prompt %}<|im_start|>assistant\n{% endif %}")


def _words():
    text = " ".join(PROMPT_TEMPLATE["video"] + PROMPT_TEMPLATE["image"])
    text += EXPAND_INSTRUCTION
    return sorted(set(re.findall(r"\w+|[^\w\s]+", text)))


def _save_word_level(path, vocab, specials, **kw):
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    tok = Tokenizer(models.WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.add_special_tokens(specials)
    post = kw.pop("post_processor", None)
    if post is not None:
        tok.post_processor = post
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="[UNK]",
                                   **kw)
    fast.save_pretrained(path)
    return fast


def write_tokenizers(qwen_dir, clip_dir):
    """Word-level tokenizers in HF's on-disk format: Qwen's (vocabulary of
    the templates' first 124 words after four specials, so every id of the
    tiny tower decodes; ChatML specials, a chat template, padded with
    <|endoftext|>) and CLIP's (97 words, start and end of text, the end
    id the largest, padded with it)."""
    from tokenizers import processors

    os.makedirs(qwen_dir, exist_ok=True)
    os.makedirs(clip_dir, exist_ok=True)
    words = _words()
    specials = ["<|endoftext|>", "<|im_start|>", "<|im_end|>", "[UNK]"]
    vocab = {w: i for i, w in enumerate(specials + words[:124])}
    _save_word_level(qwen_dir, vocab, specials, pad_token="<|endoftext|>",
                     eos_token="<|im_end|>", chat_template=CHAT_TEMPLATE)
    cvocab = {w: i for i, w in enumerate(["[UNK]"] + words[:96])}
    cvocab["<|startoftext|>"] = CLIP_EOT - 1
    cvocab["<|endoftext|>"] = CLIP_EOT
    post = processors.TemplateProcessing(
        single="<|startoftext|> $A <|endoftext|>",
        special_tokens=[("<|startoftext|>", CLIP_EOT - 1),
                        ("<|endoftext|>", CLIP_EOT)])
    _save_word_level(clip_dir, cvocab, ["<|startoftext|>", "<|endoftext|>",
                                        "[UNK]"],
                     post_processor=post, bos_token="<|startoftext|>",
                     eos_token="<|endoftext|>", pad_token="<|endoftext|>")


def write_text_checkpoints(root, seed=0):
    """Tiny HF checkpoint directories under ``root``: ``qwen`` (weights in
    shards under ``model.safetensors.index.json``, ``config.json``,
    tokenizer) and ``clip`` (one ``model.safetensors``, ``config.json``,
    tokenizer). Returns the two paths."""
    qdir, cdir = os.path.join(str(root), "qwen"), os.path.join(str(root), "clip")
    hf_qwen(seed).save_pretrained(qdir, max_shard_size="200KB",
                                  safe_serialization=True)
    hf_clip(seed=seed).save_pretrained(cdir, safe_serialization=True)
    write_tokenizers(qdir, cdir)
    return qdir, cdir
