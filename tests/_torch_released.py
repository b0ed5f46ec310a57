"""The released checkpoint and tokenizer layouts, written by the port and
loaded back, shared by ``chip_smoke.py`` (phase 8, at full width on the
card) and the CPU tests (``test_torch_offline_load.py`` at a tiny size with
the three packages blocked, ``test_torch_tokenizer.py``'s patterns and chat
template). Imports none of ``transformers``, ``tokenizers``,
``safetensors``, JAX or the JAX package."""

from __future__ import annotations

import json
import os
import sys
import time

# the packages the card does not have, which no module of the load path may
# import
ABSENT = ("transformers", "tokenizers", "safetensors")
# Qwen2.5-VL-7B-Instruct's chat template
QWEN_CHAT_TEMPLATE = (
    "{% set image_count = namespace(value=0) %}{% set video_count = "
    "namespace(value=0) %}{% for message in messages %}{% if loop.first and "
    "message['role'] != 'system' %}<|im_start|>system\nYou are a helpful "
    "assistant.<|im_end|>\n{% endif %}<|im_start|>{{ message['role'] }}\n{% "
    "if message['content'] is string %}{{ message['content'] }}<|im_end|>\n"
    "{% else %}{% for content in message['content'] %}{% if content['type'] "
    "== 'image' or 'image' in content or 'image_url' in content %}{% set "
    "image_count.value = image_count.value + 1 %}{% if add_vision_id %}"
    "Picture {{ image_count.value }}: {% endif %}<|vision_start|><|image_pad|>"
    "<|vision_end|>{% elif content['type'] == 'video' or 'video' in content "
    "%}{% set video_count.value = video_count.value + 1 %}{% if "
    "add_vision_id %}Video {{ video_count.value }}: {% endif %}"
    "<|vision_start|><|video_pad|><|vision_end|>{% elif 'text' in content %}"
    "{{ content['text'] }}{% endif %}{% endfor %}<|im_end|>\n{% endif %}{% "
    "endfor %}{% if add_generation_prompt %}<|im_start|>assistant\n{% endif %}")
QWEN_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}"
              r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
CLIP_SPLIT = (r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
              r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+")
# the special tokens at their released ids
QWEN_SPECIAL_IDS = {"<|endoftext|>": 151643, "<|im_start|>": 151644,
                    "<|im_end|>": 151645, "<|vision_start|>": 151652,
                    "<|vision_end|>": 151653, "<|image_pad|>": 151655,
                    "<|video_pad|>": 151656}
CLIP_SPECIAL_IDS = {"<|startoftext|>": 49406, "<|endoftext|>": 49407}
# words whose merges the hand-written tokenizers carry
BPE_WORDS = ("the", "video", "camera", "describe", "and", "of", "a", "man",
             "smoke", "test", "in", "is", "ing", "ion", "prompt", "engineer",
             "style", "scene", "you", "are", "<|", "|>")


def _bpe(base: dict, words, suffix: str = "", first_id: int = None):
    """(vocab, merges): ``base`` (symbol -> id) and every prefix of each
    word of symbols, built left to right one merge at a time; the last
    symbol takes ``suffix``."""
    vocab, merges = dict(base), []
    nxt = max(vocab.values()) + 1 if first_id is None else first_id
    for word in words:
        syms = list(word)
        syms[-1] += suffix
        cur = syms[0]
        for s in syms[1:]:
            if cur + s not in vocab:
                vocab[cur + s] = nxt
                nxt += 1
                merges.append(f"{cur} {s}")
            cur += s
    return vocab, merges


def write_tokenizer_dir(path: str, layout: str) -> None:
    """A small byte-level BPE tokenizer, written by hand in a released
    layout: "qwen" (Qwen2.5-VL: ``tokenizer.json`` with NFC, the Split
    regex and ByteLevel, the special tokens at their released ids;
    ``tokenizer_config.json`` with the chat template;
    ``chat_template.json``) or "clip" (ViT-L/14: NFC, a whitespace Replace
    and Lowercase, the inverted Split regex, ``</w>`` word ends, an unk
    token, RobertaProcessing; ``tokenizer_config.json`` and
    ``special_tokens_map.json``). Every byte is in the vocabulary, so any
    text encodes."""
    from kandinsky5_tpu_torch.text.tokenizer import bytes_to_unicode

    chars = list(bytes_to_unicode().values())
    os.makedirs(path, exist_ok=True)

    def dump(name, obj):
        with open(os.path.join(path, name), "w", encoding="utf-8") as f:
            json.dump(obj, f, ensure_ascii=False)

    def added(content, i, normalized=False):
        return {"id": i, "content": content, "single_word": False,
                "lstrip": False, "rstrip": False, "normalized": normalized,
                "special": True}

    if layout == "qwen":
        words = [w for word in BPE_WORDS for w in (word, "Ġ" + word)]
        vocab, merges = _bpe({c: i for i, c in enumerate(chars)}, words)
        dump("tokenizer.json", {
            "version": "1.0", "truncation": None, "padding": None,
            "added_tokens": [added(t, i) for t, i in QWEN_SPECIAL_IDS.items()],
            "normalizer": {"type": "NFC"},
            "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
                {"type": "Split", "pattern": {"Regex": QWEN_SPLIT},
                 "behavior": "Isolated", "invert": False},
                {"type": "ByteLevel", "add_prefix_space": False,
                 "trim_offsets": False, "use_regex": False}]},
            "post_processor": {"type": "ByteLevel", "add_prefix_space": False,
                               "trim_offsets": False, "use_regex": False},
            "decoder": {"type": "ByteLevel", "add_prefix_space": False,
                        "trim_offsets": False, "use_regex": False},
            "model": {"type": "BPE", "dropout": None, "unk_token": None,
                      "continuing_subword_prefix": "", "end_of_word_suffix": "",
                      "fuse_unk": False, "byte_fallback": False,
                      "ignore_merges": False, "vocab": vocab, "merges": merges}})
        dump("tokenizer_config.json", {
            "add_prefix_space": False,
            "added_tokens_decoder": {
                str(i): {k: v for k, v in added(t, i).items() if k != "id"}
                for t, i in QWEN_SPECIAL_IDS.items()},
            "additional_special_tokens": list(QWEN_SPECIAL_IDS)[1:],
            "bos_token": None, "chat_template": QWEN_CHAT_TEMPLATE,
            "clean_up_tokenization_spaces": False, "eos_token": "<|im_end|>",
            "errors": "replace", "model_max_length": 131072,
            "pad_token": "<|endoftext|>", "split_special_tokens": False,
            "tokenizer_class": "Qwen2Tokenizer", "unk_token": None})
        dump("chat_template.json", {"chat_template": QWEN_CHAT_TEMPLATE})
        return
    if layout != "clip":
        raise ValueError(f"no released layout {layout!r}")
    base = {c: i for i, c in enumerate(chars)}
    base.update({c + "</w>": 256 + i for i, c in enumerate(chars)})
    vocab, merges = _bpe(base, BPE_WORDS[:-2], suffix="</w>")
    vocab.update(CLIP_SPECIAL_IDS)
    sot, eot = CLIP_SPECIAL_IDS["<|startoftext|>"], CLIP_SPECIAL_IDS["<|endoftext|>"]
    dump("tokenizer.json", {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [added("<|startoftext|>", sot, True),
                         added("<|endoftext|>", eot)],
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "NFC"},
            {"type": "Replace", "pattern": {"Regex": r"\s+"}, "content": " "},
            {"type": "Lowercase"}]},
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": CLIP_SPLIT},
             "behavior": "Removed", "invert": True},
            {"type": "ByteLevel", "add_prefix_space": False,
             "trim_offsets": True, "use_regex": False}]},
        "post_processor": {"type": "RobertaProcessing",
                           "sep": ["<|endoftext|>", eot],
                           "cls": ["<|startoftext|>", sot],
                           "trim_offsets": False, "add_prefix_space": False},
        "decoder": {"type": "ByteLevel", "add_prefix_space": True,
                    "trim_offsets": True, "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": "<|endoftext|>",
                  "continuing_subword_prefix": "", "end_of_word_suffix": "</w>",
                  "fuse_unk": False, "byte_fallback": False,
                  "vocab": vocab, "merges": merges}})

    def special(t):
        return {"__type": "AddedToken", "content": t, "lstrip": False,
                "normalized": True, "rstrip": False, "single_word": False}
    config = {"add_prefix_space": False, "bos_token": special("<|startoftext|>"),
              "do_lower_case": True, "eos_token": special("<|endoftext|>"),
              "errors": "replace", "model_max_length": 77,
              "pad_token": "<|endoftext|>", "tokenizer_class": "CLIPTokenizer",
              "unk_token": special("<|endoftext|>")}
    dump("tokenizer_config.json", config)
    dump("special_tokens_map.json", {k: config[k] for k in (
        "bos_token", "eos_token", "pad_token", "unk_token")})


def _flat(tree, prefix=""):
    """A nested dict of tensors as {dotted key: tensor}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def write_released_layout(root: str, dit, vae, towers) -> dict:
    """The models as the released checkpoints lay them out, written by the
    port's safetensors writer under ``root``: the DiT (one file, reference
    names), the diffusers VAE (``vae/diffusion_pytorch_model.safetensors``),
    Qwen2.5-VL (``text_encoder/``: HF names in two shards under
    ``model.safetensors.index.json``, a vision entry beside them,
    ``config.json``) and CLIP (``text_encoder2/``: the whole CLIPModel's
    names, ``text_model.*`` beside a vision half, nested ``config.json``),
    each text directory with its hand-written tokenizer. Returns the
    paths."""
    import dataclasses

    import torch

    from kandinsky5_tpu_torch.checkpoint import (
        clip_hf_state_dict,
        qwen_hf_state_dict,
        vae_state_dict,
    )
    from kandinsky5_tpu_torch.utils.io import save_safetensors

    paths = {"dit": os.path.join(root, "model", "kandinsky5lite_t2v.safetensors"),
             "vae": os.path.join(root, "vae"),
             "qwen": os.path.join(root, "text_encoder"),
             "clip": os.path.join(root, "text_encoder2")}
    for p in ("model", "vae", "text_encoder", "text_encoder2"):
        os.makedirs(os.path.join(root, p), exist_ok=True)
    save_safetensors(dit.state_dict(), paths["dit"], metadata={"format": "pt"})
    save_safetensors(vae_state_dict(vae.params), os.path.join(
        paths["vae"], "diffusion_pytorch_model.safetensors"))
    qsd = qwen_hf_state_dict(towers.qwen)
    qsd["visual.merger.ln_q.weight"] = torch.ones(1280)
    names = sorted(qsd)
    weight_map = {}
    for j, part in enumerate((names[: len(names) // 2], names[len(names) // 2:])):
        fname = f"model-{j + 1:05d}-of-00002.safetensors"
        save_safetensors({k: qsd[k] for k in part},
                         os.path.join(paths["qwen"], fname))
        weight_map.update({k: fname for k in part})
    with open(os.path.join(paths["qwen"], "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)
    qc = towers.qwen.cfg
    with open(os.path.join(paths["qwen"], "config.json"), "w") as f:
        json.dump(dict(dataclasses.asdict(qc), architectures=[
            "Qwen2_5_VLForConditionalGeneration"], model_type="qwen2_5_vl",
            vision_config={"hidden_size": 1280, "out_hidden_size": qc.hidden_size}),
            f)
    csd = clip_hf_state_dict(towers.clip)
    csd.update({"vision_model.post_layernorm.weight": torch.ones(1024),
                "visual_projection.weight": torch.zeros(768, 1024),
                "text_projection.weight": torch.zeros(768, 768),
                "logit_scale": torch.tensor(4.6052)})
    save_safetensors(csd, os.path.join(paths["clip"], "model.safetensors"))
    cc = towers.clip.cfg
    with open(os.path.join(paths["clip"], "config.json"), "w") as f:
        json.dump({"architectures": ["CLIPModel"], "model_type": "clip",
                   "text_config": dataclasses.asdict(cc),
                   "vision_config": {"hidden_size": 1024}}, f)
    write_tokenizer_dir(paths["qwen"], "qwen")
    write_tokenizer_dir(paths["clip"], "clip")
    return paths


def load_round_trip(root: str, dit, vae, towers, conf, device, inputs,
                    conf_path=None) -> dict:
    """Write ``dit``, ``vae`` and ``towers`` (a ``Kandinsky5TextEmbedder``)
    in the released layouts under ``root`` (:func:`write_released_layout`),
    load them back through ``get_T2V_pipeline`` (at its default
    configuration over the paths, or ``conf_path``'s YAML naming them), and
    hold the result: every parameter bit-equal, one DiT forward on
    ``inputs`` and one text encode bit-equal to the in-memory models fed
    the same ids, none of ABSENT imported; control: one offset of the VAE
    file's header changed in place must make it unreadable. Returns the
    seconds, what was held and ``faults``, the list of what failed (empty
    when everything held)."""
    import torch

    from kandinsky5_tpu_torch.models.dit import dit_forward
    from kandinsky5_tpu_torch.pipeline import get_T2V_pipeline
    from kandinsky5_tpu_torch.text.embedder import Kandinsky5TextEmbedder
    from kandinsky5_tpu_torch.utils.io import load_sharded_safetensors

    t0 = time.perf_counter()
    paths = write_released_layout(root, dit, vae, towers)
    written = sum(os.path.getsize(os.path.join(d, f))
                  for d, _, fs in os.walk(root) for f in fs)
    t1 = time.perf_counter()
    if conf_path is not None:
        with open(conf_path) as f:
            text = f.read()
        for key, path in paths.items():
            text = text.replace(f"@{key}@", path)
        conf_path = os.path.join(root, "config.yaml")
        with open(conf_path, "w") as f:
            f.write(text)
    pipe = get_T2V_pipeline(
        dit_path=paths["dit"], vae_path=paths["vae"],
        text_encoder_path=paths["qwen"], text_encoder2_path=paths["clip"],
        conf_path=conf_path, device=device)
    if device != "cpu":
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    faults = []

    def same(what, got: dict, want: dict):
        if set(got) != set(want):
            faults.append(f"{what}: names differ ({sorted(set(got) ^ set(want))[:3]})")
            return
        bad = [k for k in want if not (got[k].dtype == want[k].dtype
                                       and torch.equal(got[k], want[k]))]
        if bad:
            faults.append(f"{what}: {len(bad)} tensors differ ({bad[:3]})")
    emb = pipe.text_embedder
    same("DiT", pipe.dit.state_dict(), dit.state_dict())
    same("VAE", _flat(pipe.vae.params), _flat(vae.params))
    same("Qwen", emb.qwen.state_dict(), towers.qwen.state_dict())
    same("CLIP", emb.clip.state_dict(), towers.clip.state_dict())
    n_params = sum(t.numel() for m in (pipe.dit, emb.qwen, emb.clip)
                   for t in m.state_dict().values()) + sum(
        t.numel() for t in _flat(pipe.vae.params).values())
    with torch.no_grad():
        got = dit_forward(pipe.dit, *inputs, scale_factor=(1.0, 2.0, 2.0))
        want = dit_forward(dit, *inputs, scale_factor=(1.0, 2.0, 2.0))
    if not torch.equal(got, want):
        faults.append("the DiT forward differs")
    mem = Kandinsky5TextEmbedder(conf.model.text_embedder, towers.qwen,
                                 towers.clip, emb.qwen_tokenizer,
                                 emb.clip_tokenizer)
    prompt = ["a smoke-test video of the camera, IT'S 東京 à 12:30\r\n"]
    got, want = emb.encode(prompt, "video"), mem.encode(prompt, "video")
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        faults.append("the text encode differs")
    ids = emb.qwen_tokenizer(prompt, return_tensors="np")["input_ids"][0]
    decoded = emb.qwen_tokenizer.decode(ids.tolist())
    if decoded != prompt[0]:
        faults.append(f"the Qwen tokenizer's decode gives {decoded!r}")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ABSENT)
    if loaded:
        faults.append(f"imported: {loaded}")
    # control: one offset digit of the VAE file's header, changed in place
    vae_file = os.path.join(paths["vae"], "diffusion_pytorch_model.safetensors")
    with open(vae_file, "r+b") as f:
        head = f.read(1 << 16)
        at = head.index(b'"data_offsets":[') + len(b'"data_offsets":[')
        at = head.index(b",", at) - 1  # the last digit of the first begin
        f.seek(at)
        f.write(b"9" if head[at:at + 1] != b"9" else b"8")
    try:
        load_sharded_safetensors(vae_file)
        faults.append("the file with a changed offset loaded")
        control = "LOADED"
    except ValueError as e:
        control = str(e).split(": ", 1)[-1]
    del pipe
    out = {"written_gb": written / 1e9, "write_s": t1 - t0, "load_s": t2 - t1,
           "params": n_params, "qwen_ids": int(len(ids)),
           "absent": [m for m in ABSENT if m not in sys.modules],
           "control": control, "faults": faults}
    return out
