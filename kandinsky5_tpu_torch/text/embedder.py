"""Text conditioning: Qwen2.5-VL embeddings and the CLIP pooled vector.

Counterpart of ``kandinsky5_tpu/text/embedder.py``. Texts are wrapped in the
fixed system-prompt template, encoded by the Qwen text tower (last hidden
states, cropped past the template) and pooled by CLIP; the outputs are
padded to the config's ``max_length`` with boolean masks. Prompt expansion
runs the same Qwen tower autoregressively.

Tokenizers are injected: :meth:`Kandinsky5TextEmbedder.from_pretrained`
reads each checkpoint directory's HF tokenizer files with the port's own
:class:`~kandinsky5_tpu_torch.text.tokenizer.Tokenizer` (no
``transformers`` or ``tokenizers``), and any object with the same call
signature, ``apply_chat_template`` and ``decode`` serves as well.
"""

from __future__ import annotations

import json
import os
import time
from typing import List, NamedTuple, Optional

import torch
from torch import nn

from kandinsky5_tpu_torch.config import TextEmbedderConfig
from kandinsky5_tpu_torch.text.clip import (
    ClipTextConfig,
    ClipTextModel,
    clip_pooled,
)
from kandinsky5_tpu_torch.text.qwen import (
    QwenTextConfig,
    QwenTextModel,
    qwen_encode,
    qwen_generate,
    quantize_qwen_decode_params,
)
from kandinsky5_tpu_torch.utils import default_device

# Conditioning prompt templates and crop offsets: behavioural constants of
# the released checkpoints (the DiT was trained on embeddings made under
# these exact system prompts), reproduced verbatim.
PROMPT_TEMPLATE = {
    "video": (
        "<|im_start|>system\nYou are a promt engineer. Describe the video in detail.",
        "Describe how the camera moves or shakes, describe the zoom and view angle, whether it follows the objects.",
        "Describe the location of the video, main characters or objects and their action.",
        "Describe the dynamism of the video and presented actions.",
        "Name the visual style of the video: whether it is a professional footage, user generated content, some kind of animation, video game or scren content.",
        "Describe the visual effects, postprocessing and transitions if they are presented in the video.",
        "Pay attention to the order of key actions shown in the scene.<|im_end|>",
        "<|im_start|>user\n{}<|im_end|>",
    ),
    "image": (
        "<|im_start|>system\nYou are a promt engineer. Describe the image by detailing the color, shape, size, texture, quantity, text, spatial relationships of the objects and background:<|im_end|>",
        "<|im_start|>user\n{}<|im_end|>",
    ),
}
CROP_START = {"video": 129, "image": 41}

# Prompt-beautifier instruction for prompt expansion, reproduced verbatim.
EXPAND_INSTRUCTION = """You are a prompt beautifier that transforms short user video descriptions into rich, detailed English prompts specifically optimized for video generation models.
        Here are some example descriptions from the dataset that the model was trained:
        1. "In a dimly lit room with a cluttered background, papers are pinned to the wall and various objects rest on a desk. Three men stand present: one wearing a red sweater, another in a black sweater, and the third in a gray shirt. The man in the gray shirt speaks and makes hand gestures, while the other two men look forward. The camera remains stationary, focusing on the three men throughout the sequence. A gritty and realistic visual style prevails, marked by a greenish tint that contributes to a moody atmosphere. Low lighting casts shadows, enhancing the tense mood of the scene."
        2. "In an office setting, a man sits at a desk wearing a gray sweater and seated in a black office chair. A wooden cabinet with framed pictures stands beside him, alongside a small plant and a lit desk lamp. Engaged in a conversation, he makes various hand gestures to emphasize his points. His hands move in different positions, indicating different ideas or points. The camera remains stationary, focusing on the man throughout. Warm lighting creates a cozy atmosphere. The man appears to be explaining something. The overall visual style is professional and polished, suitable for a business or educational context."
        3. "A person works on a wooden object resembling a sunburst pattern, holding it in their left hand while using their right hand to insert a thin wire into the gaps between the wooden pieces. The background features a natural outdoor setting with greenery and a tree trunk visible. The camera stays focused on the hands and the wooden object throughout, capturing the detailed process of assembling the wooden structure. The person carefully threads the wire through the gaps, ensuring the wooden pieces are securely fastened together. The scene unfolds with a naturalistic and instructional style, emphasizing the craftsmanship and the methodical steps taken to complete the task."
        IImportantly! These are just examples from a large training dataset of 200 million videos.
        Rewrite Prompt: "{}" to get high-quality video generation. Answer only with expanded prompt."""

MAX_NEW_TOKENS = 256


class TextEmbeddings(NamedTuple):
    """What a text embedder hands the DiT: (B, L, in_text_dim) embeddings,
    (B, in_text_dim2) pooled embedding, (B, L) bool validity mask."""

    text_embeds: torch.Tensor
    pooled_embed: torch.Tensor
    mask: torch.Tensor


def _read_json(checkpoint_path, name: str) -> Optional[dict]:
    try:
        with open(os.path.join(str(checkpoint_path), name)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _read_config_json(checkpoint_path) -> Optional[dict]:
    return _read_json(checkpoint_path, "config.json")


def qwen_config_from_json(checkpoint_path) -> Optional[QwenTextConfig]:
    """:class:`QwenTextConfig` from an HF checkpoint's ``config.json``, the
    text dims top-level or nested under ``text_config``; None (the released
    7B defaults) when the file is absent."""
    raw = _read_config_json(checkpoint_path)
    if raw is None:
        return None
    tc = raw.get("text_config", raw)
    hidden = int(tc["hidden_size"])
    heads = int(tc["num_attention_heads"])
    return QwenTextConfig(
        vocab_size=int(tc["vocab_size"]),
        hidden_size=hidden,
        intermediate_size=int(tc["intermediate_size"]),
        num_hidden_layers=int(tc["num_hidden_layers"]),
        num_attention_heads=heads,
        num_key_value_heads=int(tc.get("num_key_value_heads", heads)),
        head_dim=int(tc.get("head_dim", hidden // heads)),
        rms_norm_eps=float(tc.get("rms_norm_eps", 1e-6)),
        rope_theta=float(tc.get("rope_theta", 1000000.0)),
        tie_word_embeddings=bool(tc.get("tie_word_embeddings", False)),
    )


def clip_config_from_json(checkpoint_path) -> Optional[ClipTextConfig]:
    """:class:`ClipTextConfig` from an HF CLIPTextModel ``config.json``
    (``text_config`` nesting accepted); None (ViT-L/14) when absent."""
    raw = _read_config_json(checkpoint_path)
    if raw is None:
        return None
    tc = raw.get("text_config", raw)
    return ClipTextConfig(
        vocab_size=int(tc["vocab_size"]),
        hidden_size=int(tc["hidden_size"]),
        intermediate_size=int(tc["intermediate_size"]),
        num_hidden_layers=int(tc["num_hidden_layers"]),
        num_attention_heads=int(tc["num_attention_heads"]),
        max_position_embeddings=int(tc.get("max_position_embeddings", 77)),
        eos_token_id=int(tc.get("eos_token_id", 2)),
    )


class Kandinsky5TextEmbedder(nn.Module):
    """Qwen2.5-VL + CLIP conditioning encoder. A module, so that ``.to()``
    moves both towers (and the int8 decode copy, once built) together.
    ``int8_expand=True`` runs prompt expansion on int8 decode weights
    (:func:`~kandinsky5_tpu_torch.text.qwen.quantize_qwen_decode_params`);
    the conditioning encode keeps the dense weights."""

    def __init__(self, conf: TextEmbedderConfig, qwen: QwenTextModel = None,
                 clip: ClipTextModel = None, qwen_tokenizer=None,
                 clip_tokenizer=None, int8_expand: bool = False):
        super().__init__()
        self.conf = conf
        self.qwen = qwen
        self.clip = clip
        self.qwen_int8 = None
        self.qwen_tokenizer = qwen_tokenizer
        self.clip_tokenizer = clip_tokenizer
        self.int8_expand = int8_expand
        # the last expansion: new tokens and seconds
        self.last_expansion: dict = {}
        self._gen_conf = None

    @classmethod
    def from_pretrained(cls, conf: TextEmbedderConfig, dtype=torch.bfloat16,
                        device=None, int8_expand: bool = False):
        """Weights, dims and tokenizers from the HF checkpoint directories
        ``conf.qwen.checkpoint_path`` and ``conf.clip.checkpoint_path``: each
        directory's ``config.json`` (the released 7B / ViT-L/14 dims when it
        is absent), its safetensors (one file, shards under
        ``model.safetensors.index.json``, or every file there) and its
        tokenizer. Qwen is built in ``dtype``, CLIP in fp32, on ``device``
        (the CUDA card when None)."""
        from kandinsky5_tpu_torch.checkpoint import (
            clip_from_state_dict,
            qwen_from_state_dict,
        )
        from kandinsky5_tpu_torch.text.tokenizer import Tokenizer
        from kandinsky5_tpu_torch.utils.io import load_sharded_safetensors

        device = default_device(device)
        qpath, cpath = conf.qwen.checkpoint_path, conf.clip.checkpoint_path
        qwen = qwen_from_state_dict(load_sharded_safetensors(qpath),
                                    qwen_config_from_json(qpath),
                                    device=device, dtype=dtype)
        clip = clip_from_state_dict(load_sharded_safetensors(cpath),
                                    clip_config_from_json(cpath),
                                    device=device, dtype=torch.float32)
        return cls(conf, qwen, clip,
                   qwen_tokenizer=Tokenizer.from_pretrained(qpath),
                   clip_tokenizer=Tokenizer.from_pretrained(cpath),
                   int8_expand=int8_expand)

    # -- tokenization -------------------------------------------------

    def _qwen_tokenize(self, texts: List[str], type_of_content: str):
        template = "\n".join(PROMPT_TEMPLATE[type_of_content])
        crop = CROP_START[type_of_content]
        full = [template.format(t) for t in texts]
        enc = self.qwen_tokenizer(
            full, max_length=self.conf.qwen.max_length + crop,
            truncation=True, padding="max_length", return_tensors="np")
        return (torch.from_numpy(enc["input_ids"]),
                torch.from_numpy(enc["attention_mask"]).bool(), crop)

    def _clip_tokenize(self, texts: List[str]):
        enc = self.clip_tokenizer(
            texts, max_length=self.conf.clip.max_length, truncation=True,
            add_special_tokens=True, padding="max_length", return_tensors="np")
        return (torch.from_numpy(enc["input_ids"]),
                torch.from_numpy(enc["attention_mask"]))

    # -- public API ---------------------------------------------------

    @torch.no_grad()
    def encode(self, texts: List[str],
               type_of_content: str = "video") -> TextEmbeddings:
        """Padded conditioning of ``texts``: Qwen's cropped last hidden
        states with their mask, and CLIP's pooled vector."""
        ids, mask, crop = self._qwen_tokenize(texts, type_of_content)
        embeds, emb_mask = qwen_encode(self.qwen, ids, mask, crop)
        cids, cmask = self._clip_tokenize(texts)
        pooled = clip_pooled(self.clip, cids, cmask)
        return TextEmbeddings(embeds, pooled, emb_mask)

    def _generation_config(self) -> dict:
        """The Qwen checkpoint's ``generation_config.json`` ({} when absent:
        greedy), read once."""
        if self._gen_conf is None:
            self._gen_conf = _read_json(self.conf.qwen.checkpoint_path,
                                        "generation_config.json") or {}
        return self._gen_conf

    def _decode_model(self) -> QwenTextModel:
        if not self.int8_expand:
            return self.qwen
        if self.qwen_int8 is None:
            self.qwen_int8 = quantize_qwen_decode_params(self.qwen)
        return self.qwen_int8

    def expand_prompt(self, prompt: str, sample: Optional[bool] = None,
                      seed: int = 0) -> str:
        """Prompt beautification by Qwen generation, up to 256 new tokens.
        ``sample=None`` follows the checkpoint's generation config as HF
        ``generate`` does (do_sample, temperature, top_p, top_k (50 when the
        file omits it), repetition_penalty; seeded); False forces greedy;
        True forces sampling with the config's knobs."""
        messages = [{"role": "user",
                     "content": [{"type": "text",
                                  "text": EXPAND_INSTRUCTION.format(prompt)}]}]
        text = self.qwen_tokenizer.apply_chat_template(
            messages, tokenize=False, add_generation_prompt=True)
        ids = self.qwen_tokenizer(text, return_tensors="np")["input_ids"]
        gc = self._generation_config()
        do_sample = bool(gc.get("do_sample", False)) if sample is None \
            else bool(sample)
        model = self._decode_model()
        t = time.perf_counter()
        new_ids = qwen_generate(
            model, ids, max_new_tokens=MAX_NEW_TOKENS, do_sample=do_sample,
            temperature=float(gc.get("temperature", 1.0)),
            top_p=float(gc.get("top_p", 1.0)),
            top_k=int(gc.get("top_k", 50)),
            repetition_penalty=float(gc.get("repetition_penalty", 1.0)),
            seed=seed)
        self.last_expansion = {"new_tokens": int(len(new_ids)),
                               "prompt_tokens": int(ids.shape[-1]),
                               "seconds": time.perf_counter() - t}
        return self.qwen_tokenizer.decode(new_ids.tolist(),
                                          skip_special_tokens=True)


def get_text_embedder(conf: TextEmbedderConfig, dtype=torch.bfloat16,
                      device=None, int8_expand: bool = False):
    """The embedder of ``conf``'s checkpoint directories
    (:meth:`Kandinsky5TextEmbedder.from_pretrained`)."""
    return Kandinsky5TextEmbedder.from_pretrained(
        conf, dtype=dtype, device=device, int8_expand=int8_expand)
