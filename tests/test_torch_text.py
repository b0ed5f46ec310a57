"""The port's text towers (kandinsky5_tpu_torch/text/) against the JAX
package's on tiny random configs (those of tests/test_text_encoders.py), in
fp32 on the CPU: Qwen2.5-VL's hidden states, encode crop, greedy and sampled
decode, logits processing and int8 decode weights; CLIP's pooled vector
under both pooling rules; the state-dict converters and carriers; the
config.json readers; the embedder's encode on word-level tokenizers saved to
disk. Tolerance 2e-4, the JAX golden tests' fp32 bound, unless stated."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kandinsky5_tpu.text import qwen as jq
from kandinsky5_tpu.text.clip import clip_text_forward as jax_clip_forward
from kandinsky5_tpu_torch.checkpoint import (
    clip_state_dict_from_jax,
    convert_clip_state_dict,
    convert_qwen_state_dict,
    qwen_from_state_dict,
    qwen_state_dict_from_jax,
)
from kandinsky5_tpu_torch.text import qwen as pq
from kandinsky5_tpu_torch.text.clip import clip_text_forward
from kandinsky5_tpu_torch.text.embedder import (
    CROP_START,
    clip_config_from_json,
    qwen_config_from_json,
)
from kandinsky5_tpu_torch.text.qwen import QwenTextConfig

from ._torch_parity import FLIP_ULPS
from ._torch_text import (
    CLIP_EOT,
    CLIP_KW,
    QWEN_KW,
    clip_pair,
    hf_clip,
    hf_qwen,
    qwen_pair,
    state_dict_np,
)

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def qwen():
    hf = hf_qwen()
    return (hf,) + qwen_pair(hf)


def _padded_batch(seed=0, b=2, l=11, n_valid=(11, 8)):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, QWEN_KW["vocab_size"], size=(b, l))
    mask = np.arange(l)[None] < np.asarray(n_valid)[:, None]
    return ids, mask


def test_qwen_hidden_states_match_jax_and_hf(qwen):
    """Batch 2, the second item right-padded: the valid positions equal
    JAX's and HF's ``hidden_states[-1]``."""
    hf, jcfg, jparams, model = qwen
    ids, mask = _padded_batch()
    want = np.asarray(jq.qwen_hidden_states(jparams, jcfg, jnp.asarray(ids),
                                            jnp.asarray(mask)))
    got = pq.qwen_hidden_states(model, torch.from_numpy(ids),
                                torch.from_numpy(mask)).numpy()
    with torch.no_grad():
        ref = hf(input_ids=torch.from_numpy(ids),
                 attention_mask=torch.from_numpy(mask.astype(np.int64)),
                 output_hidden_states=True,
                 return_dict=True)["hidden_states"][-1].numpy()
    assert got.shape == (2, 11, QWEN_KW["hidden_size"])
    for b, n in enumerate(mask.sum(1)):
        np.testing.assert_allclose(got[b, :n], want[b, :n], **TOL)
        np.testing.assert_allclose(got[b, :n], ref[b, :n], **TOL)


def test_qwen_encode_crop_and_mask(qwen):
    _, jcfg, jparams, model = qwen
    ids, mask = _padded_batch(seed=3, l=14, n_valid=(14, 9))
    want, want_mask = jq.qwen_encode(jparams, jcfg, ids, mask, 5)
    got, got_mask = pq.qwen_encode(model, torch.from_numpy(ids),
                                   torch.from_numpy(mask), 5)
    assert tuple(got.shape) == (2, 9, QWEN_KW["hidden_size"])
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    np.testing.assert_array_equal(got_mask.numpy(), mask[:, 5:])
    for b, n in enumerate(got_mask.sum(1).tolist()):
        np.testing.assert_allclose(got[b, :n].numpy(), np.asarray(want)[b, :n],
                                   **TOL)


@pytest.mark.parametrize("stop", ["no_eos", "eos_stops_early"])
def test_qwen_greedy_generate_matches_jax(qwen, stop):
    """8 new tokens, token-equal to JAX's; with an EOS set to JAX's third
    token, both stop before it and return two."""
    _, jcfg, jparams, model = qwen
    ids = np.random.RandomState(1).randint(0, 128, size=(1, 7))
    free = jq.qwen_generate_greedy(jparams, jcfg, ids, max_new_tokens=8,
                                   eos_token_ids=())
    eos = () if stop == "no_eos" else (int(free[2]),)
    want = jq.qwen_generate_greedy(jparams, jcfg, ids, max_new_tokens=8,
                                   eos_token_ids=eos)
    got = pq.qwen_generate_greedy(model, ids, max_new_tokens=8,
                                  eos_token_ids=eos)
    assert len(want) == (8 if stop == "no_eos" else 2)
    np.testing.assert_array_equal(got, want)


def test_qwen_prefill_matches_jax(qwen):
    _, jcfg, jparams, model = qwen
    ids = np.random.RandomState(4).randint(0, 128, size=(1, 9))
    jcache, jlogits = jq._prefill(jparams, jcfg, jnp.asarray(ids, jnp.int32),
                                  12)
    cache, logits = pq._prefill(model, torch.from_numpy(ids), 12)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(cache.numpy(), np.asarray(jcache), **TOL)


KNOBS = {
    "repetition_penalty": dict(rep_penalty=1.3),
    "temperature": dict(temperature=0.7),
    "top_k": dict(top_k=20),
    "top_p": dict(top_p=0.8),
    "all": dict(rep_penalty=1.05, temperature=0.7, top_k=20, top_p=0.8),
}


@pytest.mark.parametrize("knob", list(KNOBS))
def test_process_logits_matches_jax(knob):
    kw = dict(dict(temperature=1.0, top_p=1.0, top_k=0, rep_penalty=1.0),
              **KNOBS[knob])
    rng = np.random.RandomState(0)
    v = 97
    logits = (rng.randn(1, v) * 3.0).astype(np.float32)
    presence = np.zeros(v, bool)
    presence[[3, 5, 40, 96]] = True
    want = np.asarray(jq._process_logits(jnp.asarray(logits),
                                         jnp.asarray(presence), **kw))
    got = pq._process_logits(torch.from_numpy(logits),
                             torch.from_numpy(presence), **kw).numpy()
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)


def test_sampled_decode_repeats_with_its_seed(qwen):
    """torch's draws cannot match jax.random's: a seed gives the same tokens
    again, another seed others (temperature 3 spreads the draws)."""
    _, _, _, model = qwen
    ids = np.random.RandomState(7).randint(0, 128, size=(1, 9))
    kw = dict(max_new_tokens=8, eos_token_ids=(127,), do_sample=True,
              temperature=3.0, top_k=50, top_p=0.95, repetition_penalty=1.05)
    a = pq.qwen_generate(model, ids, seed=1, **kw)
    b = pq.qwen_generate(model, ids, seed=1, **kw)
    c = pq.qwen_generate(model, ids, seed=2, **kw)
    np.testing.assert_array_equal(a, b)
    assert not (len(a) == len(c) and np.array_equal(a, c))
    assert (a < 128).all() and len(a) <= 8


def _near_half(w, scale):
    """Codes whose pre-rounding value |w / scale| lies within FLIP_ULPS fp32
    ulps of a .5 boundary: there JAX (which may divide as a reciprocal
    multiply) and the port may round apart."""
    v = np.abs(w.astype(np.float32) / scale.astype(np.float32))
    return np.abs(v - np.floor(v) - 0.5) <= FLIP_ULPS * 2.0 ** -24 * v


def test_int8_decode_params_match_jax(qwen):
    """Codes equal JAX's except where a code sits near a rounding boundary
    (at most one step there), scales equal; with JAX's codes loaded, the
    port's int8 prefill logits equal JAX's (2e-4); its own codes' logits stay
    within 5 % of the dense logits' scale, the JAX package's bound."""
    _, jcfg, jparams, model = qwen
    jqp = jax.tree.map(np.asarray, jq.quantize_qwen_decode_params(jparams))
    qmodel = pq.quantize_qwen_decode_params(model)
    want = qwen_state_dict_from_jax(jqp)
    got = {k: v.numpy() for k, v in qmodel.state_dict().items()}
    assert sorted(got) == sorted(want)
    dense = {k: v.numpy() for k, v in model.state_dict().items()}
    n_codes = n_near = 0
    for key in got:
        if not key.endswith("weight_q"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=0)
            continue
        w = dense[key[:-2]]
        scale = got[key[:-len("weight_q")] + "scale"]
        near = _near_half(w, scale[:, None])
        diff = np.abs(got[key].astype(np.int32) - want[key].astype(np.int32))
        assert diff.max() <= 1 and not (diff.astype(bool) & ~near).any(), key
        n_codes += w.size
        n_near += int(near.sum())
    assert n_near < 1e-3 * n_codes  # the exemption is not vacuous
    ids = np.random.RandomState(3).randint(0, 128, size=(1, 11))
    _, jlog = jq._prefill(jax.tree.map(jnp.asarray, jqp), jcfg,
                          jnp.asarray(ids, jnp.int32), 16)
    teacher = pq.quantize_qwen_decode_params(model)
    teacher.load_state_dict({k: torch.from_numpy(np.array(v))
                             for k, v in want.items()})
    _, log_t = pq._prefill(teacher, torch.from_numpy(ids), 16)
    np.testing.assert_allclose(log_t.numpy(), np.asarray(jlog), **TOL)
    _, log_q = pq._prefill(qmodel, torch.from_numpy(ids), 16)
    _, log_d = pq._prefill(model, torch.from_numpy(ids), 16)
    rel = float((log_q - log_d).abs().max() / log_d.abs().max())
    assert rel < 0.05, rel
    # the quantized decode runs: greedy tokens from the int8 weights
    assert len(pq.qwen_generate_greedy(qmodel, ids, max_new_tokens=4,
                                       eos_token_ids=())) == 4


@pytest.mark.parametrize("eos_token_id", [2, CLIP_EOT - 1],
                         ids=["legacy_argmax", "first_eos"])
def test_clip_pooled_matches_jax_and_hf(eos_token_id):
    """Both pooling rules. Item 1 holds id 97 at position 2 and end-of-text
    (98, the largest id) from position 6: the legacy rule pools at the
    largest id (6), the other at the first id equal to ``eos_token_id`` (2
    for 97); item 0, which holds no 97, pools at 0 under that rule."""
    hf = hf_clip(eos_token_id)
    jcfg, jparams, model = clip_pair(hf, eos_token_id)
    rng = np.random.RandomState(2)
    ids = rng.randint(1, 90, size=(2, 12))
    ids[0, 9:] = CLIP_EOT
    ids[1, 6:] = CLIP_EOT
    ids[1, 2] = CLIP_EOT - 1
    mask = np.ones((2, 12), np.int64)
    mask[0, 10:] = 0
    mask[1, 7:] = 0
    hidden, pooled = clip_text_forward(model, torch.from_numpy(ids),
                                       torch.from_numpy(mask))
    jhidden, jpooled = jax_clip_forward(jparams, jcfg, jnp.asarray(ids),
                                        jnp.asarray(mask))
    with torch.no_grad():
        ref = hf(input_ids=torch.from_numpy(ids),
                 attention_mask=torch.from_numpy(mask))["pooler_output"]
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jpooled), **TOL)
    np.testing.assert_allclose(pooled.numpy(), ref.numpy(), **TOL)
    for b, n in enumerate(mask.sum(1)):
        np.testing.assert_allclose(hidden[b, :n].numpy(),
                                   np.asarray(jhidden)[b, :n], **TOL)
    pos = [(9, 6), (0, 2)][eos_token_id != 2]
    for b in range(2):
        np.testing.assert_array_equal(pooled[b].numpy(),
                                      hidden[b, pos[b]].numpy())


def test_jax_carriers_give_the_hf_weights(qwen):
    """``qwen_state_dict_from_jax`` / ``clip_state_dict_from_jax`` carry the
    JAX pytrees (converted from HF) back to exactly HF's tensors under the
    port's names."""
    hf, _, jparams, model = qwen
    got = qwen_state_dict_from_jax(jax.tree.map(np.asarray, jparams))
    want = {k: v.numpy() for k, v in model.state_dict().items()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    clip = hf_clip()
    _, cparams, cmodel = clip_pair(clip)
    got = clip_state_dict_from_jax(jax.tree.map(np.asarray, cparams))
    want = {k: v.numpy() for k, v in cmodel.state_dict().items()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    hf_sd = state_dict_np(clip)
    assert "text_model.embeddings.position_ids" not in convert_clip_state_dict(hf_sd)
    assert sorted(convert_clip_state_dict(hf_sd)) == sorted(want)


def test_qwen_converter_takes_both_hf_layouts(qwen):
    """``model.language_model.*`` (transformers >= 4.52) and ``model.*``
    (before) convert to the same names; the vision tower is dropped."""
    hf, _, _, model = qwen
    new = state_dict_np(hf)
    assert any(k.startswith("model.language_model.") for k in new)
    assert any(k.startswith("model.visual.") for k in new)
    old = {("model." + k[len("model.language_model."):]
            if k.startswith("model.language_model.") else
            "visual." + k[len("model.visual."):]
            if k.startswith("model.visual.") else k): v
           for k, v in new.items()}
    a, b = convert_qwen_state_dict(new), convert_qwen_state_dict(old)
    assert sorted(a) == sorted(b) == sorted(model.state_dict())
    for k in a:
        np.testing.assert_array_equal(a[k].numpy(), b[k].numpy())
    ids, mask = _padded_batch(seed=5)
    m_old = qwen_from_state_dict(old, QwenTextConfig(**QWEN_KW), device="cpu",
                                 dtype=torch.float32)
    np.testing.assert_array_equal(
        pq.qwen_hidden_states(m_old, ids, mask).numpy(),
        pq.qwen_hidden_states(model, ids, mask).numpy())


@pytest.mark.parametrize("nested", [False, True], ids=["top_level",
                                                       "text_config"])
def test_config_from_json(tmp_path, nested):
    qdims = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                 num_hidden_layers=2, num_attention_heads=4,
                 num_key_value_heads=2, rms_norm_eps=1e-5,
                 rope_theta=10000.0, tie_word_embeddings=True)
    cdims = dict(CLIP_KW, max_position_embeddings=40, eos_token_id=CLIP_EOT)
    for name, dims in (("qwen", qdims), ("clip", cdims)):
        (tmp_path / name).mkdir()
        raw = {"text_config": dims} if nested else dims
        (tmp_path / name / "config.json").write_text(json.dumps(raw))
    q = qwen_config_from_json(tmp_path / "qwen")
    assert q == QwenTextConfig(head_dim=16, **qdims)
    c = clip_config_from_json(tmp_path / "clip")
    assert (c.hidden_size, c.max_position_embeddings, c.eos_token_id) == \
        (32, 40, CLIP_EOT)
    assert qwen_config_from_json(tmp_path / "absent") is None
    assert clip_config_from_json(tmp_path / "absent") is None


@pytest.fixture(scope="module")
def embedders(tmp_path_factory):
    """The JAX and the port's ``Kandinsky5TextEmbedder.from_pretrained`` on
    the same tiny HF checkpoints and tokenizers written to disk."""
    from kandinsky5_tpu.config import TextEmbedderConfig as JaxTEC
    from kandinsky5_tpu.config import TextEncoderConfig as JaxEnc
    from kandinsky5_tpu.text.embedder import (
        Kandinsky5TextEmbedder as JaxEmbedder,
    )
    from kandinsky5_tpu_torch.config import TextEmbedderConfig, TextEncoderConfig
    from kandinsky5_tpu_torch.text.embedder import Kandinsky5TextEmbedder

    from ._torch_text import write_text_checkpoints

    root = tmp_path_factory.mktemp("text")
    qdir, cdir = write_text_checkpoints(root)
    jconf = JaxTEC(qwen=JaxEnc(str(qdir), 64, 16), clip=JaxEnc(str(cdir), 32, 20))
    conf = TextEmbedderConfig(qwen=TextEncoderConfig(str(qdir), 64, 16),
                              clip=TextEncoderConfig(str(cdir), 32, 20))
    return (JaxEmbedder.from_pretrained(jconf, dtype=jnp.float32),
            Kandinsky5TextEmbedder.from_pretrained(conf, dtype=torch.float32,
                                                   device="cpu"))


LONG_PROMPT = ("A man in a gray sweater sits at a wooden desk in an office, "
               "the camera remains stationary, warm lighting, a cozy "
               "atmosphere, the scene is professional and polished")


@pytest.mark.parametrize("kind", ["video", "image"])
def test_embedder_encode_matches_jax(embedders, kind):
    """Both templates, a batch of two prompts of different lengths: the
    cropped embeddings over the valid positions, the mask and the pooled
    vector equal JAX's."""
    jemb, emb = embedders
    texts = [LONG_PROMPT, "a dog in a red hat"]
    want = jemb.encode(texts, kind)
    got = emb.encode(texts, kind)
    mask = got.mask.numpy()
    np.testing.assert_array_equal(mask, np.asarray(want.mask))
    assert got.text_embeds.shape == (2, 16, 64) and mask[0].any()
    for b in range(2):
        np.testing.assert_allclose(got.text_embeds[b, mask[b]].numpy(),
                                   np.asarray(want.text_embeds)[b, mask[b]],
                                   **TOL)
    np.testing.assert_allclose(got.pooled_embed.numpy(),
                               np.asarray(want.pooled_embed), **TOL)
    ids, _, crop = emb._qwen_tokenize(texts, kind)
    assert crop == CROP_START[kind] and ids.shape == (2, 16 + crop)


def test_embedder_expand_prompt_matches_jax(embedders):
    """Greedy expansion (no generation config on disk: greedy, as HF's
    default) gives JAX's text; the port records its token count."""
    jemb, emb = embedders
    want = jemb.expand_prompt("a dog in a red hat")
    got = emb.expand_prompt("a dog in a red hat")
    assert got == want
    assert emb.last_expansion["new_tokens"] <= 256
