"""The work of the layers the benchmark reads: operations and bytes computed
from a cell's shapes, never from the program.

Every count is of what the inputs need: each input byte read once, each
output byte written once, and for attention only the key blocks a mask
keeps. The numbers in ``PERF.md`` section 6 (K1 16.433 ms at
(1, 47616, 28, 64), K2 2.474 ms at (1, 47616, 1792) x 7168, K6 57.265 ms at
90 % kept of (1, 93696, 28, 64)) follow from these functions and
``peaks.bound_s``; the tests hold them to those values.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple, Sequence, Tuple

BF16 = 2
I32 = 4


class Work(NamedTuple):
    """bf16 tensor-core operations and device-memory bytes of one call."""

    flops: float
    nbytes: float


# ---------------------------------------------------------------------------
# kernels of the DiT
# ---------------------------------------------------------------------------

def attention_dense(b: int, lq: int, lk_valid: int, lk: int, h: int,
                    d: int) -> Work:
    """Softmax attention of ``lq`` queries over ``lk`` keys of which
    ``lk_valid`` are unmasked (K1): QK^T and PV over the valid keys."""
    flops = 4.0 * b * lq * lk_valid * h * d
    nbytes = BF16 * b * h * d * (2 * lq + 2 * lk)
    return Work(flops, nbytes)


def attention_sparse(b: int, s: int, sk: int, h: int, d: int,
                     kept: float, block: int = 64) -> Work:
    """NABLA block-sparse attention (K6) at a kept fraction of its
    (s / 64) x (sk / 64) blocks: q, k, v and the output once, the kept
    entries of the kv lists and the per-row counts."""
    flops = 4.0 * b * s * sk * h * d * kept
    rows = b * h * (s // block)
    nbytes = (BF16 * b * h * d * (2 * s + 2 * sk)
              + I32 * (rows * (sk // block) * kept + rows))
    return Work(flops, nbytes)


def modulated_ff(rows: int, d: int, ff: int) -> Work:
    """The modulated feed-forward (K2: the modulation pass and its two
    GEMMs): x and both weights read, the output written."""
    flops = 4.0 * rows * d * ff
    nbytes = BF16 * (2 * rows * d + 2 * d * ff)
    return Work(flops, nbytes)


def linear(rows: int, k: int, n: int) -> Work:
    return Work(2.0 * rows * k * n, BF16 * (rows * k + k * n + rows * n))


# ---------------------------------------------------------------------------
# model FLOPs of one DiT step (one no-CFG forward)
# ---------------------------------------------------------------------------

def dit_step_flops(dit: dict, tokens: int, text_len: int, text_valid: int,
                   kept: Sequence[float]) -> float:
    """Matrix-product operations of one DiT forward at ``tokens`` visual
    tokens and ``text_len`` padded text tokens of which ``text_valid`` are
    valid; ``kept`` gives each visual block's kept fraction of its
    self-attention (1.0 for dense). ``dit`` holds the published
    ``dit_params``."""
    d, ff, td = dit["model_dim"], dit["ff_dim"], dit["time_dim"]
    patch = dit["patch_size"][0] * dit["patch_size"][1] * dit["patch_size"][2]
    in_vis = 2 * dit["in_visual_dim"] + 1 if dit["visual_cond"] \
        else dit["in_visual_dim"]
    s, l, lv = tokens, text_len, text_valid
    f = 0.0
    # embeddings, time MLP, out layer
    f += 2.0 * l * dit["in_text_dim"] * d + 2.0 * dit["in_text_dim2"] * td
    f += 2.0 * s * patch * in_vis * d
    f += 2.0 * d * td + 2.0 * td * td
    f += 2.0 * td * 2 * d + 2.0 * s * d * patch * dit["out_visual_dim"]
    # text blocks: modulation, QKV + out, attention over the valid keys, FF
    per_text = 2.0 * td * 6 * d + 8.0 * l * d * d + 4.0 * l * lv * d \
        + 4.0 * l * d * ff
    f += dit["num_text_blocks"] * per_text
    if len(kept) != dit["num_visual_blocks"]:
        raise ValueError(f"{len(kept)} kept fractions for "
                         f"{dit['num_visual_blocks']} visual blocks")
    for k in kept:
        f += 2.0 * td * 9 * d                          # modulation
        f += 8.0 * s * d * d + 4.0 * s * s * d * k     # self-attention
        f += 4.0 * s * d * d + 4.0 * l * d * d + 4.0 * s * lv * d  # cross
        f += 4.0 * s * d * ff                          # FF
    return f


# ---------------------------------------------------------------------------
# the streaming VAE decode
# ---------------------------------------------------------------------------

KERNEL_CHANNELS = (128, 256, 512)


class Conv(NamedTuple):
    """One conv of a decode: ``k`` its cubic kernel size (3 or 1), the
    input frames it reads, the output frames it writes, the plane size."""

    cin: int
    cout: int
    k: int
    t_in: int
    t_out: int
    h: int
    w: int

    @property
    def work(self) -> Work:
        vox = self.t_out * self.h * self.w
        flops = 2.0 * self.k ** 3 * self.cin * self.cout * vox
        nbytes = BF16 * (self.t_in * self.h * self.w * self.cin
                         + self.k ** 3 * self.cin * self.cout
                         + vox * self.cout)
        return Work(flops, nbytes)

    @property
    def k3(self) -> bool:
        """A 3x3x3 conv between 128-512 channels: the convs the port's
        conv kernel serves (conv_in and conv_out are outside it)."""
        return (self.k == 3 and self.cin in KERNEL_CHANNELS
                and self.cout in KERNEL_CHANNELS)


class MidAttention(NamedTuple):
    """The decoder's frame-causal mid attention on one chunk: ``t`` query
    frames of ``s`` voxels, ``filled`` carried frames, width ``d``."""

    s: int
    d: int
    filled: int
    t: int

    @property
    def work(self) -> Work:
        pairs = sum(self.filled + i + 1 for i in range(self.t))
        flops = 4.0 * self.d * self.s * self.s * pairs
        nbytes = BF16 * self.s * self.d * (2 * self.t + 2 * (self.filled + self.t))
        return Work(flops, nbytes)

    @property
    def projection_flops(self) -> float:
        return 4 * 2.0 * self.t * self.s * self.d * self.d


def up_plan(levels: int) -> list:
    """(upsample space, upsample time) per up block: the HunyuanVideo
    decoder's 8x space, 4x time."""
    return [(i < 3, 1 <= i and i != levels - 1) for i in range(levels)]


def chunks(t_lat: int, chunk_lat: int) -> list:
    """Latent frames of each chunk of the streaming decode: the first one
    frame longer."""
    out = [min(t_lat, chunk_lat + 1)]
    while sum(out) < t_lat:
        out.append(min(chunk_lat, t_lat - sum(out)))
    return out


def decode_schedule(latent_shape: Sequence[int],
                    channels: Sequence[int] = (128, 256, 512, 512),
                    chunk_lat: int = 3, attn_past: int = 4,
                    latent_channels: int = 16,
                    layers_per_block: int = 2) -> Iterator:
    """Every conv and mid attention of one streaming decode of a (B, T', H',
    W', C) latent, in order (batch 1)."""
    _, t_lat, hl, wl = latent_shape[:4]
    rev = list(reversed(channels))
    filled = 0
    for n, f in enumerate(chunks(t_lat, chunk_lat)):
        first = n == 0
        pad = 0 if first else 2

        def conv3(cin, cout, t, h, w):
            return Conv(cin, cout, 3, t + pad, t, h, w)

        h, w, t = hl, wl, f
        yield Conv(latent_channels, latent_channels, 1, t, t, h, w)
        yield conv3(latent_channels, rev[0], t, h, w)
        c = rev[0]
        yield from _resnet(conv3, c, c, t, h, w)
        yield MidAttention(h * w, c, filled, t)
        filled = min(filled + t, attn_past)
        yield from _resnet(conv3, c, c, t, h, w)
        c_in = c
        for i, (up_s, up_t) in enumerate(up_plan(len(channels))):
            c_out = rev[i]
            for j in range(layers_per_block + 1):
                yield from _resnet(conv3, c_in if j == 0 else c_out, c_out,
                                   t, h, w)
            c_in = c_out
            if up_s or up_t:
                if up_t:
                    t = 1 + 2 * (t - 1) if first else 2 * t
                if up_s:
                    h, w = 2 * h, 2 * w
                yield conv3(c_out, c_out, t, h, w)
        yield conv3(channels[0], 3, t, h, w)


def _resnet(conv3, cin: int, cout: int, t: int, h: int, w: int):
    yield conv3(cin, cout, t, h, w)
    yield conv3(cout, cout, t, h, w)
    if cin != cout:
        yield Conv(cin, cout, 1, t, t, h, w)


def decode_flops(latent_shape: Sequence[int], **kw) -> float:
    """Matrix-product operations of one streaming decode: every conv, the
    mid attention over its visible keys and its four projections."""
    total = 0.0
    for op in decode_schedule(latent_shape, **kw):
        total += op.work.flops
        if isinstance(op, MidAttention):
            total += op.projection_flops
    return total


def k3_bound_and_count(latent_shape: Sequence[int], bound, **kw
                       ) -> Tuple[float, int]:
    """(summed bound, launches) of the decode's convs that the conv kernel
    serves."""
    convs = [op for op in decode_schedule(latent_shape, **kw)
             if isinstance(op, Conv) and op.k3]
    return sum(bound(*c.work) for c in convs), len(convs)


def k4_bound_and_count(latent_shape: Sequence[int], bound, **kw
                       ) -> Tuple[float, int]:
    """(summed bound, launches) of the decode's mid attentions."""
    atts = [op for op in decode_schedule(latent_shape, **kw)
            if isinstance(op, MidAttention)]
    return sum(bound(*a.work) for a in atts), len(atts)
