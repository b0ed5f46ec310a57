"""The port's tokenizer (``kandinsky5_tpu_torch/text/tokenizer.py``) against
``tokenizers`` and ``transformers`` on byte-level BPE tokenizers trained here
(no download) and written in the two released layouts: Qwen2.5-VL's
(``tokenizer.json`` with NFC, the Split regex and ByteLevel,
``tokenizer_config.json`` naming ``Qwen2Tokenizer`` with the chat template,
``chat_template.json``) and CLIP ViT-L/14's (NFC, a whitespace Replace and
Lowercase, the inverted Split regex, ``</w>`` suffixes, an unk token,
RobertaProcessing; ``tokenizer_config.json`` naming ``CLIPTokenizer`` and
``special_tokens_map.json``). Ids, masks (padded and truncated) and decodes
over a hypothesis corpus of CJK, accents, combining marks, digits, emoji,
``\\r\\n`` runs, upper-case contractions and special tokens; the chat
template against ``transformers``' render; the word-level layouts of the
text tests; components that are not implemented raise."""

import copy
import json
import os

import numpy as np
import pytest
from hypothesis import HealthCheck, example, given, settings
from hypothesis import strategies as st

from kandinsky5_tpu_torch.text.tokenizer import Tokenizer, translate_pattern

from ._torch_released import (
    CLIP_SPLIT,
    QWEN_CHAT_TEMPLATE,
    QWEN_SPECIAL_IDS,
    QWEN_SPLIT,
)

QWEN_SPECIALS = list(QWEN_SPECIAL_IDS)
# the corpus the tokenizers are trained on (their merges cover it; other
# text falls back to bytes, or to CLIP's unk token)
TRAIN = [
    "In a dimly lit room with a cluttered background, papers are pinned to "
    "the wall. The camera remains stationary; warm lighting creates a cozy "
    "atmosphere. IT'S A MAN'S WORLD, isn't it? We'll see: 1234 5678.",
    "Ünïcödé àccents, naïve café résumé — 東京 日本語 中文 한국어 😀🎉 "
    "emoji\r\n\r\nA second paragraph\tafter tabs   and spaces.",
] * 20
FRAGMENTS = [
    "a man", " walks", "The", " CAMERA", "IT'S", "DON'T", "We'LL", "they're",
    " 'd", "123", "٣٤", "４５", "3.14", "東京", "日本語の", "中文", "한국어",
    "é", "é", "ä", "naïve", "Ç", "ß", "Σ", "ΟΔΟΣ", "😀", "🎉", "👍🏽",
    "\r\n", "\r\n\r\n", "\n", "\t", "   ", " ", " ", "　", "!", "?!",
    "...", "—", "<|im_start|>", "<|im_end|>", "<|endoftext|>",
    "<|startoftext|>", "<|STARTOFTEXT|>", "<tool_call>", "@#$%", "x",
]
corpus = st.lists(st.sampled_from(FRAGMENTS), max_size=24).map("".join) | st.text(
    alphabet=st.sampled_from(list("aZ09 \r\n\t'!東é́😀ß")), max_size=40)
SETTINGS = settings(max_examples=120, deadline=None, derandomize=True,
                    database=None,
                    suppress_health_check=[HealthCheck.function_scoped_fixture])


def _write_qwen(path):
    from tokenizers import (AddedToken, Regex, Tokenizer as HFTokenizer, decoders,
                            models, normalizers, pre_tokenizers, processors,
                            trainers)

    tok = HFTokenizer(models.BPE())
    tok.normalizer = normalizers.NFC()
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(QWEN_SPLIT), behavior="isolated", invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False,
                                 trim_offsets=False)])
    tok.post_processor = processors.ByteLevel(add_prefix_space=False,
                                              trim_offsets=False, use_regex=False)
    tok.decoder = decoders.ByteLevel(add_prefix_space=False, trim_offsets=False,
                                     use_regex=False)
    tok.train_from_iterator(TRAIN, trainers.BpeTrainer(
        vocab_size=500, show_progress=False,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    tok.add_special_tokens([AddedToken(t, special=True, normalized=False)
                            for t in QWEN_SPECIALS])
    tok.add_tokens([AddedToken("<tool_call>", special=False, normalized=False)])
    os.makedirs(path, exist_ok=True)
    tok.save(os.path.join(path, "tokenizer.json"))
    added = {str(tok.token_to_id(t)): dict(
        content=t, lstrip=False, normalized=False, rstrip=False,
        single_word=False, special=t != "<tool_call>")
        for t in QWEN_SPECIALS + ["<tool_call>"]}
    config = {"add_prefix_space": False, "added_tokens_decoder": added,
              "additional_special_tokens": QWEN_SPECIALS[1:],
              "bos_token": None, "chat_template": QWEN_CHAT_TEMPLATE,
              "clean_up_tokenization_spaces": False, "eos_token": "<|im_end|>",
              "errors": "replace", "model_max_length": 131072,
              "pad_token": "<|endoftext|>", "split_special_tokens": False,
              "tokenizer_class": "Qwen2Tokenizer", "unk_token": None}
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump(config, f)
    with open(os.path.join(path, "chat_template.json"), "w") as f:
        json.dump({"chat_template": QWEN_CHAT_TEMPLATE}, f)


def _write_clip(path):
    from tokenizers import (AddedToken, Regex, Tokenizer as HFTokenizer, decoders,
                            models, normalizers, pre_tokenizers, processors,
                            trainers)

    tok = HFTokenizer(models.BPE(unk_token="<|endoftext|>",
                                 continuing_subword_prefix="",
                                 end_of_word_suffix="</w>"))
    tok.normalizer = normalizers.Sequence([
        normalizers.NFC(), normalizers.Replace(Regex(r"\s+"), " "),
        normalizers.Lowercase()])
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(CLIP_SPLIT), behavior="removed", invert=True),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(TRAIN, trainers.BpeTrainer(
        vocab_size=900, show_progress=False, end_of_word_suffix="</w>",
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
        special_tokens=["<|startoftext|>", "<|endoftext|>"]))
    tok.add_special_tokens([AddedToken("<|startoftext|>", special=True,
                                       normalized=True),
                            AddedToken("<|endoftext|>", special=True,
                                       normalized=False)])
    sot, eot = tok.token_to_id("<|startoftext|>"), tok.token_to_id("<|endoftext|>")
    tok.post_processor = processors.RobertaProcessing(
        sep=("<|endoftext|>", eot), cls=("<|startoftext|>", sot),
        trim_offsets=False, add_prefix_space=False)
    os.makedirs(path, exist_ok=True)
    tok.save(os.path.join(path, "tokenizer.json"))

    def special(t):
        return {"__type": "AddedToken", "content": t, "lstrip": False,
                "normalized": True, "rstrip": False, "single_word": False}
    config = {"add_prefix_space": False, "bos_token": special("<|startoftext|>"),
              "do_lower_case": True, "eos_token": special("<|endoftext|>"),
              "errors": "replace", "model_max_length": 77,
              "pad_token": "<|endoftext|>", "tokenizer_class": "CLIPTokenizer",
              "unk_token": special("<|endoftext|>")}
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump(config, f)
    stm = {k: config[k] for k in ("bos_token", "eos_token", "pad_token",
                                  "unk_token")}
    with open(os.path.join(path, "special_tokens_map.json"), "w") as f:
        json.dump(stm, f)


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    """name -> (directory, the port's tokenizer, transformers',
    tokenizers')."""
    from tokenizers import Tokenizer as HFTokenizer
    from transformers import AutoTokenizer

    root = tmp_path_factory.mktemp("tok")
    out = {}
    for name, write in (("qwen", _write_qwen), ("clip", _write_clip)):
        path = str(root / name)
        write(path)
        out[name] = (path, Tokenizer.from_pretrained(path),
                     AutoTokenizer.from_pretrained(path),
                     HFTokenizer.from_file(os.path.join(path, "tokenizer.json")))
    return out


@pytest.mark.parametrize("name", ["qwen", "clip"])
@SETTINGS
@given(text=corpus, special=st.booleans())
@example(text="ΟΔΟΣ IT'S\r\n\r\n  <|STARTOFTEXT|>é", special=True)
def test_ids_equal_tokenizers(layouts, name, text, special):
    """One text's ids, with and without the post-processor's special
    tokens, equal ``tokenizers``'."""
    _, ours, _, hf = layouts[name]
    assert ours.encode(text, add_special_tokens=special) == \
        hf.encode(text, add_special_tokens=special).ids


@pytest.mark.parametrize("name", ["qwen", "clip"])
@SETTINGS
@given(texts=st.lists(corpus, min_size=1, max_size=3),
       max_length=st.integers(3, 40))
def test_padded_truncated_batch_equals_transformers(layouts, name, texts,
                                                    max_length):
    """The embedder's calls: a batch padded to max_length and truncated
    (special tokens counted in it), as numpy ids and masks; and a single
    text with neither."""
    _, ours, theirs, _ = layouts[name]
    kw = dict(max_length=max_length, truncation=True, padding="max_length",
              add_special_tokens=True, return_tensors="np")
    got, want = ours(texts, **kw), theirs(texts, **kw)
    for key in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(got[key], want[key])
        assert got[key].dtype == want[key].dtype
    got, want = ours(texts[0], return_tensors="np"), theirs(texts[0],
                                                           return_tensors="np")
    np.testing.assert_array_equal(got["input_ids"], want["input_ids"])


@pytest.mark.parametrize("name", ["qwen", "clip"])
@SETTINGS
@given(data=st.data(), skip=st.booleans())
def test_decode_equals_transformers(layouts, name, data, skip):
    """Decodes of a text's ids and of arbitrary ids (split byte sequences,
    special tokens, ids past the vocabulary), with and without the special
    tokens."""
    _, ours, theirs, _ = layouts[name]
    ids = theirs(data.draw(corpus))["input_ids"]
    assert ours.decode(ids, skip_special_tokens=skip) == \
        theirs.decode(ids, skip_special_tokens=skip)
    n = len(theirs)
    ids = data.draw(st.lists(st.integers(0, n + 3), max_size=30))
    assert ours.decode(ids, skip_special_tokens=skip) == \
        theirs.decode(ids, skip_special_tokens=skip)


def test_chat_template_equals_transformers(layouts):
    """The embedder's expansion message (text parts) and a string message
    render as ``transformers`` renders them, and tokenize alike."""
    from kandinsky5_tpu_torch.text.embedder import EXPAND_INSTRUCTION

    _, ours, theirs, _ = layouts["qwen"]
    for messages in (
            [{"role": "user", "content": [{"type": "text", "text":
                                           EXPAND_INSTRUCTION.format("a cat")}]}],
            [{"role": "system", "content": "Be brief."},
             {"role": "user", "content": "Hi\r\nthere"}]):
        for gen in (True, False):
            want = theirs.apply_chat_template(messages, tokenize=False,
                                              add_generation_prompt=gen)
            assert ours.apply_chat_template(messages, tokenize=False,
                                            add_generation_prompt=gen) == want
        assert ours(want, return_tensors="np")["input_ids"].tolist() == \
            [theirs(want)["input_ids"]]


def test_word_level_layouts_equal_transformers(tmp_path):
    """The word-level tokenizers the text tests save (Whitespace, WordLevel,
    TemplateProcessing) give ``transformers``' ids, masks and decodes."""
    from transformers import AutoTokenizer

    from kandinsky5_tpu_torch.text.embedder import PROMPT_TEMPLATE

    from ._torch_text import write_tokenizers

    write_tokenizers(str(tmp_path / "q"), str(tmp_path / "c"))
    texts = ["\n".join(PROMPT_TEMPLATE["video"]).format("a dog in a red hat"),
             "a man sits, at a desk!! unknownword <|im_start|>"]
    for d in ("q", "c"):
        ours = Tokenizer.from_pretrained(tmp_path / d)
        theirs = AutoTokenizer.from_pretrained(str(tmp_path / d))
        for n in (20, 150):
            kw = dict(max_length=n, truncation=True, padding="max_length",
                      return_tensors="np")
            got, want = ours(texts, **kw), theirs(texts, **kw)
            for key in ("input_ids", "attention_mask"):
                np.testing.assert_array_equal(got[key], want[key])
        ids = list(range(0, 100, 3))
        assert ours.decode(ids, skip_special_tokens=True) == \
            theirs.decode(ids, skip_special_tokens=True)


@pytest.mark.parametrize("where, change, names", [
    ("normalizer", {"type": "Strip", "strip_left": True, "strip_right": True},
     "Strip"),
    ("pre_tokenizer", {"type": "Metaspace", "replacement": "_",
                       "prepend_scheme": "always", "split": True}, "Metaspace"),
    ("pre_tokenizer", {"type": "Split", "pattern": {"Regex": "a"},
                       "behavior": "MergedWithPrevious", "invert": False},
     "MergedWithPrevious"),
    ("pre_tokenizer", {"type": "ByteLevel", "add_prefix_space": True,
                       "trim_offsets": True, "use_regex": True},
     "add_prefix_space"),
    ("post_processor", {"type": "BertProcessing", "sep": ["x", 1],
                        "cls": ["y", 2]}, "BertProcessing"),
    ("decoder", {"type": "WordPiece", "prefix": "##", "cleanup": True},
     "WordPiece"),
    ("model.type", "Unigram", "Unigram"),
    ("model.byte_fallback", True, "byte_fallback"),
    ("added", {"lstrip": True}, "lstrip"),
])
def test_unimplemented_component_raises(layouts, where, change, names):
    """A component or option the port does not implement raises, naming
    itself."""
    path = layouts["qwen"][0]
    with open(os.path.join(path, "tokenizer.json")) as f:
        spec = json.load(f)
    spec = copy.deepcopy(spec)
    if where.startswith("model."):
        spec["model"][where.split(".")[1]] = change
    elif where == "added":
        spec["added_tokens"][0].update(change)
    else:
        spec[where] = change
    with pytest.raises(ValueError, match=names):
        Tokenizer(spec, {"tokenizer_class": "Qwen2Tokenizer"})
    with pytest.raises(ValueError, match="LlamaTokenizer"):
        Tokenizer(json.load(open(os.path.join(path, "tokenizer.json"))),
                  {"tokenizer_class": "LlamaTokenizer"})


def test_patterns_take_oniguruma_classes():
    """``\\s`` is Oniguruma's (no U+001C-U+001F, which Python's ``\\s``
    takes; U+0085 and U+3000 in), ``\\p{L}`` takes letters of every script
    and no digit, ``\\w`` takes combining marks (Python's does not)."""
    import re

    s = re.compile(translate_pattern(r"\s"))
    assert not s.match("\x1c") and s.match("\x85") and s.match("　")
    assert re.fullmatch(translate_pattern(r"\p{L}+"), "aÉ東한") is not None
    assert re.match(translate_pattern(r"\p{L}"), "٣") is None
    assert re.fullmatch(translate_pattern(r"\w+"), "é") is not None
    assert re.fullmatch(translate_pattern(r"[^\s\p{L}]+"), "!٣") is not None
    with pytest.raises(ValueError, match="property"):
        translate_pattern(r"\p{Greek}")
