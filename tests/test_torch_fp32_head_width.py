"""fp32 at head widths 32 and 128, the parts that run without the card:
the wrappers of K1, K2, K3, K5, K6, K7 and K8 route fp32 tensors at dh 32
and 128 to their `_f32` C symbols with the width and the h2 residual
layout (D//128, B, Tq, 128 // dh), with the library faked; other widths
raise before any launch; K2's shared-memory plan fits at fp32 for the
paths' groups; the 3xTF32 products meet the fp32 gate at both widths where
one TF32 pass does not; and a model of the fp32 flash kernels' split tiles
(`swz`, `Lanes`, `split_tile` and the fragment loads of
`csrc/flash_attention.cu` namespace `f32`) at each width: a bijection onto
the tile's floats, every fragment reading its operand, and every load and
store of a warp free of shared-memory bank conflicts. The plain versions
at these widths are held to the JAX package in test_torch_head_width.py,
the kernels to the plain versions on the card in
test_torch_head_width_card.py."""

import numpy as np
import pytest
import torch

from asr_ttl_mtl_tpu_torch.ops import LAUNCHES, reset_launch_counts
from asr_ttl_mtl_tpu_torch.ops import decode_attention as PD
from asr_ttl_mtl_tpu_torch.ops import flash_attention as PF

FP32_REL = 2e-5  # chip_smoke.py's gate on an fp32 kernel: a share of its plain version's largest output


class FakeLib:
    """Records each C call (symbol, arguments); every call returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append((name, args))
            return 0

        return fn


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers take their card path, into a FakeLib: the flash
    wrappers on CPU tensors, K1's and K2's on meta tensors that call
    themselves CUDA (their CPU check looks at the device type)."""
    lib = FakeLib()
    monkeypatch.setattr(PF, "on_card", lambda *a: True)
    for mod in (PF, PD):
        monkeypatch.setattr(mod._cuda, "lib", lambda name: lib)
        monkeypatch.setattr(mod._cuda, "stream_handle", lambda device: 0)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    reset_launch_counts()
    yield lib
    reset_launch_counts()


def _launched():
    return {k: n for k, n in LAUNCHES.items() if n}


# ------------------------------------------------------ the flash wrappers ---


def _flash_call(kernel, dh, d=256):
    """(wrapper call, C symbol, launch key, arguments check) of one fp32
    flash wrapper at head width dh, d = 256 split into 256 // dh heads."""
    b, tq, tk, n_head = 2, 20, 30, d // dh
    q, k, g = torch.zeros((b, tq, d)), torch.zeros((b, tk, d)), torch.zeros((b, tq, d))
    res = torch.zeros((d // 128, b, tq, 128 // dh))
    qs, ks = torch.zeros((4, tq, dh)), torch.zeros((4, tk, dh))
    lse7 = torch.zeros((4, tq, 1))

    def natural(d_at, h_at):
        return lambda args: args[d_at] // args[h_at] == dh and args[h_at] == n_head

    def split(causal, q_offset):
        return lambda args: args[8] == dh and args[10] == causal and args[11] == q_offset

    return {
        "K3": (lambda: PF.flash_attention_h2(q, k, k, n_head=n_head), "flash_h2_fwd_f32", "flash_attention_h2_f32",
               lambda args: natural(8, 9)(args) and args[4] == 0),
        "K3-lse": (lambda: PF.flash_attention_h2(q, k, k, n_head=n_head, return_lse=True), "flash_h2_fwd_f32",
                   "flash_attention_h2_lse_f32", lambda args: natural(8, 9)(args) and args[4] != 0),
        "K6": (lambda: PF.flash_attention_h2_bwd(q, k, k, res, res, g, n_head=n_head), "flash_h2_bwd_f32",
               "flash_attention_h2_bwd_f32", natural(12, 13)),
        "K5": (lambda: PF.flash_attention_mh(q, k, k, n_head=n_head), "flash_mh_fwd_f32", "flash_attention_mh_f32",
               natural(7, 8)),
        "K7": (lambda: PF.flash_attention(qs, ks, ks, causal=True), "flash_fwd_f32", "flash_attention_f32",
               split(1, 0)),
        "K7-q_offset": (lambda: PF.flash_attention(qs, ks, ks, causal=True, q_offset=10, return_lse=True),
                        "flash_fwd_f32", "flash_attention_lse_f32", split(1, 10)),
        "K8": (lambda: PF.flash_attention_bwd(qs, ks, ks, qs, lse7, qs, causal=True), "flash_bwd_f32",
               "flash_attention_bwd_f32", lambda args: args[12] == dh and args[14] == 1),
    }[kernel]


@pytest.mark.parametrize("dh", [32, 128])
@pytest.mark.parametrize("kernel", ["K3", "K3-lse", "K6", "K5", "K7", "K7-q_offset", "K8"])
def test_flash_wrappers_call_the_f32_symbol_at_the_width(fake_card, kernel, dh):
    """One call of the `_f32` symbol with the head width in its arguments
    (d and n_head, or dh), counted once under the `_f32` key; K3's lse
    (D//128, B, Tq, 128 // dh): 4 heads a lane at dh 32, one at dh 128."""
    call, symbol, key, args_ok = _flash_call(kernel, dh)
    out = call()
    first = out[0] if isinstance(out, tuple) else out
    assert first.dtype == torch.float32
    assert [name for name, _ in fake_card.calls] == [symbol]
    assert args_ok(fake_card.calls[0][1])
    assert _launched() == {key: 1}
    if kernel == "K3-lse":
        assert tuple(out[1].shape) == (2, 2, 20, 128 // dh)


@pytest.mark.parametrize("dh", [32, 128])
def test_k6_fp32_takes_the_residuals_of_the_width(fake_card, dh):
    """K6 at fp32 takes lse and delta of (D//128, B, Tq, 128 // dh) alone."""
    d, b, tq = 256, 2, 20
    q = torch.zeros((b, tq, d))
    for hpb in (1, 2, 4):
        res = torch.zeros((d // 128, b, tq, hpb))
        if hpb == 128 // dh:
            PF.flash_attention_h2_bwd(q, q, q, res, res, q, n_head=d // dh)
        else:
            with pytest.raises(ValueError, match="lse/delta"):
                PF.flash_attention_h2_bwd(q, q, q, res, res, q, n_head=d // dh)
    assert [name for name, _ in fake_card.calls] == ["flash_h2_bwd_f32"]


# -------------------------------------------------------- K1 and K2 ----------


@pytest.mark.parametrize("dh", [32, 128])
@pytest.mark.parametrize("int8", [False, True], ids=["K2", "K1"])
def test_decode_wrappers_call_the_f32_symbol_at_the_width(fake_card, int8, dh):
    """fp32 q (and fp32 caches for K2) at dh 32 and 128: `decode_attn_f32`
    / `decode_attn_i8_f32`, with d and n_head, counted under `_f32`; K2 at
    group 5 over 1500 keys with its plan's cluster size."""
    d, n_head, b, group, tk = 512, 512 // dh, 2, 5, 1536
    meta = dict(device="meta")
    q = torch.zeros((b * group, 1, d), **meta)
    if int8:
        ck = torch.zeros((1, b, tk, d), dtype=torch.int8, **meta)
        sc = torch.ones((1, b, tk), **meta)
        out = PD.decode_attention_i8(q, ck, sc, ck, sc, 0, n_head, scale=1.0, valid_upto=1499, group=group)
        symbol, key = "decode_attn_i8_f32", "decode_attention_i8_f32"
    else:
        ck = torch.zeros((1, b, tk, d), **meta)
        out = PD.decode_attention(q, ck, ck, 0, n_head, scale=1.0, valid_upto=1499, group=group)
        symbol, key = "decode_attn_f32", "decode_attention_f32"
    assert out.dtype == torch.float32 and tuple(out.shape) == (b * group, 1, d)
    ((name, args),) = fake_card.calls
    assert name == symbol
    at_d = 11 if int8 else 9  # d, then n_head
    assert args[at_d] // args[at_d + 1] == dh
    if not int8:
        assert args[12] == PD.k2_plan(b, n_head, 1500, group, 4, dh)
    assert _launched() == {key: 1}


# a width each fp32 kernel still refuses (dh -> (K8's, K1's and K2's, K5's
# and K7's)): K3 and K6 serve 32, 64 and 128; K1 and K2 every multiple of 8
# from 8 to 256, K5, K7 and K8 from 8 to 768
REFUSED = {16: (776, 776, 20), 80: (776, 1024, 776), 96: (1024, 776, 20), 256: (776, 1024, 776)}


@pytest.mark.parametrize("dh", [16, 80, 96, 256])
def test_other_widths_still_raise_in_fp32(fake_card, dh):
    """A width no kernel serves raises in fp32 before any launch, naming the
    widths served: K3 and K6 (where d is a multiple of 128) at dh; K7 and
    K8, and K2 and K1, at a width past 1-768, and K5 at one past 8-768 or
    not a multiple of 8 (REFUSED[dh])."""
    n_head = 2
    d = n_head * dh
    q = torch.zeros((2, 20, d))
    calls = [(lambda: PF.flash_attention_h2(q, q, q, n_head=n_head), "fp32 kernel takes a head width of 32, 64, 128")]
    if d % 128 == 0:
        res = torch.zeros((d // 128, 2, 20, max(1, 128 // dh)))
        calls.append((lambda: PF.flash_attention_h2_bwd(q, q, q, res, res, q, n_head=n_head),
                      "fp32 kernel takes a head width of 32, 64, 128"))
    w8, wd, wf = REFUSED[dh]
    q8, lse7 = torch.zeros((4, 20, w8)), torch.zeros((4, 20, 1))
    qd = torch.zeros((2, 1, n_head * wd), device="meta")
    ck = torch.zeros((1, 2, 128, n_head * wd), device="meta")
    ck8 = torch.zeros((1, 2, 128, n_head * wd), dtype=torch.int8, device="meta")
    sc = torch.ones((1, 2, 128), device="meta")
    qw = torch.zeros((2, 20, n_head * wf))
    calls += [(lambda: PF.flash_attention_mh(qw, qw, qw, n_head=n_head), "multiple of 8 from 8 to 768"),
              (lambda: PF.flash_attention(q8, q8, q8, causal=True), "from 1 to 768"),
              (lambda: PF.flash_attention_bwd(q8, q8, q8, q8, lse7, q8, causal=True), "from 1 to 768"),
              (lambda: PD.decode_attention(qd, ck, ck, 0, n_head, scale=1.0), "from 1 to 768"),
              (lambda: PD.decode_attention_i8(qd, ck8, sc, ck8, sc, 0, n_head, scale=1.0), "from 1 to 768")]
    for call, message in calls:
        with pytest.raises(ValueError, match=message):
            call()
    assert fake_card.calls == [] and sum(LAUNCHES.values()) == 0


@pytest.mark.parametrize("dh", [32, 128])
def test_k2_plan_fits_shared_memory_at_fp32(dh):
    """The plan's shared memory at fp32, the source's k2_smem_bytes (a ring
    of 2 fp32 tiles, 8 threads a row in P.V at every width), fits in a CTA
    for groups 1, 5, 9 and 16 over a window's 1500 keys and a 448-row self
    cache, at batch 1 and 8."""
    ring = 2 * 128 * (4 * dh + 16)
    # group 1: q, 128 scores, 16 key slices of P.V partials, the row statistics, one float a thread
    assert PD.k2_smem_bytes(1, 128, 4, dh) == ring + 4 * (dh + 128 + 16 * dh + 4 + 128)
    for batch in (1, 8):
        for n_keys in (1500, 448):
            for group in (1, 5, 9, 16):
                split = PD.k2_plan(batch, 512 // dh, n_keys, group, 4, dh)
                assert PD.k2_smem_bytes(group, -(-n_keys // split), 4, dh) <= 227 * 1024, (batch, n_keys, group)


# ----------------------------------------------------- 3xTF32 precision -----


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """`cvt.rna.tf32.f32`: a 10-bit mantissa, to nearest, ties away."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_cut(x: torch.Tensor) -> torch.Tensor:
    """The TF32 value the tensor cores read from an fp32 register."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _mm_tf32(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b with TF32 operands and fp32 sums: one pass or three (small a
    big b + big a small b + big a big b), as test_torch_fp32.py emulates the
    kernels at dh 64."""
    a_big, b_big = _tf32_rna(a), _tf32_rna(b)
    if passes == 1:
        return a_big @ b_big
    return _tf32_cut(a - a_big) @ b_big + a_big @ _tf32_cut(b - b_big) + a_big @ b_big


@pytest.mark.parametrize("dh", [32, 128])
def test_3xtf32_products_meet_the_fp32_gate_at_the_width(dh):
    """On seeded (2, 1500, dh) inputs, the scores q k^T dh^-0.5 over 1500
    keys and P V over 1500 keys taken in 3xTF32 stay within FP32_REL of the
    float64 result's largest entry; one TF32 pass misses it."""
    rng = np.random.RandomState(dh)
    q, k, v = (torch.from_numpy(rng.randn(2, 1500, dh).astype(np.float32)) for _ in range(3))
    scale = dh**-0.5
    s64 = (q.double() @ k.double().transpose(-1, -2)) * scale
    p64 = torch.softmax(s64, dim=-1)
    o64 = p64 @ v.double()
    for passes in (3, 1):
        s = _mm_tf32(q, k.transpose(-1, -2), passes) * scale
        o = _mm_tf32(p64.float(), v, passes)
        for what, got, want in (("scores", s, s64), ("P V", o, o64)):
            share = (got.double() - want).abs().max().item() / (FP32_REL * want.abs().max().item())
            assert (share <= 1.0) == (passes == 3), f"{what} in {passes} TF32 pass(es) at dh {dh}: {share:.3f}"


# ------------------------------------- the split tiles of namespace f32 -----
# The formulas of `csrc/flash_attention.cu` namespace f32, one for one:
# `swz`, `split_tile`, `lanes` (struct `Lanes`), `frag_b_rows`,
# `frag_b_cols` and `frag_a`; at dh 128 the dk/dv kernel's raw K and V
# tiles, `swz_raw`, `load_raw<..., true>` and `frag_a_raw`. Offsets are in
# floats from the tile's start.

THREADS = 128  # kThreads


def swz(r):
    return (((r >> 1) & 3) << 1) ^ ((r & 1) << 2)


def split_tile_stores(dh, rows):
    """`split_tile<kDh, kRows>`: per (iteration j, thread i) its two 16-byte
    stores, each (float offset, [(row, column, part)] of its 4 floats),
    part 0 big and 1 small."""
    split_f = 2 * dh
    out = {}
    for j in range(rows * dh // 4 // THREADS):
        for tid in range(THREADS):
            i = tid + j * THREADS
            r, c4 = i // (dh // 4), i % (dh // 4)
            lo = [(r, 4 * c4, 0), (r, 4 * c4, 1), (r, 4 * c4 + 1, 0), (r, 4 * c4 + 1, 1)]
            hi = [(r, 4 * c4 + 2, 0), (r, 4 * c4 + 2, 1), (r, 4 * c4 + 3, 0), (r, 4 * c4 + 3, 1)]
            first, s = (c4 >> 2) & 1, swz(r)
            row = r * split_f
            out[j, tid] = [(row + (((2 * c4 + first) ^ s) << 2), hi if first else lo),
                           (row + (((2 * c4 + 1 - first) ^ s) << 2), lo if first else hi)]
    return out


def lanes(dh, lane):
    split_f = 2 * dh
    g, t = lane // 4, lane % 4
    rows = [g * split_f + (((4 * e + t) ^ swz(g)) << 2) for e in range(2)]
    cols = [[(2 * t + p) * split_f + (((4 * e + g // 2) ^ swz(2 * t + p)) << 2) + (g & 1) * 2 for e in range(2)]
            for p in range(2)]
    return rows, cols


def frag_b_rows(dh, lane, n, ks):
    """The 16-byte load of `frag_b_rows`: (big, small) of b0 then of b1."""
    rows, _ = lanes(dh, lane)
    return [(rows[ks & 1] + 32 * (ks >> 1) + 8 * n * 2 * dh, 4)]


def frag_b_cols(dh, lane, j, n):
    """The two 8-byte loads of `frag_b_cols`: (big, small) of b0, of b1."""
    _, cols = lanes(dh, lane)
    base = 32 * (n >> 1) + 8 * j * 2 * dh
    return [(base + cols[0][n & 1], 2), (base + cols[1][n & 1], 2)]


def frag_a(dh, lane, r0, ks):
    """The two 16-byte loads of `frag_a`: row r0 + g (a0, a2), row r0 + g + 8 (a1, a3)."""
    rows, _ = lanes(dh, lane)
    base = rows[ks & 1] + 32 * (ks >> 1) + r0 * 2 * dh
    return [(base, 4), (base + 8 * 2 * dh, 4)]


def conflict_free(accesses):
    """One warp-wide load or store of `width` floats a lane, [(offset, width)]
    by lane: served 8 lanes at a time for 16 bytes, 16 for 8 and 32 for 4;
    free of bank conflicts where no bank holds two distinct words of one
    phase's lanes (lanes on the same word share it)."""
    per_phase = {4: 8, 2: 16, 1: 32}[accesses[0][1]]
    for p0 in range(0, 32, per_phase):
        banks = {}
        for off, w in accesses[p0:p0 + per_phase]:
            for word in range(off, off + w):
                banks.setdefault(word % 32, set()).add(word)
        if any(len(words) > 1 for words in banks.values()):
            return False
    return True


def _inverse(dh, rows):
    """(row, column, part) -> float offset of a split tile of `rows` rows."""
    where = {}
    for stores in split_tile_stores(dh, rows).values():
        for off, floats in stores:
            for k, key in enumerate(floats):
                assert key not in where, f"{key} stored twice"
                where[key] = off + k
    return where


@pytest.mark.parametrize("dh", [32, 64, 128])
def test_split_tile_is_a_bijection_onto_the_tile(dh):
    """Every (row, column, big or small) of a 64-row tile lands in one
    float of the 64 x 2dh split tile, and every float is written once."""
    where = _inverse(dh, 64)
    assert len(where) == 64 * dh * 2
    assert sorted(where.values()) == list(range(64 * 2 * dh))
    assert all(where[r, c, p] // (2 * dh) == r for r, c, p in where)  # a row stays in its row


@pytest.mark.parametrize("dh", [32, 64, 128])
def test_fragment_loads_read_their_operands(dh):
    """Each lane's fragment loads read the (big, small) pairs the mma wants:
    `frag_b_rows` row 8n + g, columns 8ks + 2t and + 1; `frag_b_cols` rows
    8j + 2t and + 1, column 8n + g; `frag_a` rows r0 + g and r0 + g + 8,
    columns 8ks + 2t and + 1."""
    at = {off: key for key, off in _inverse(dh, 64).items()}
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for ks in range(dh // 8):
            for n in range(4):
                ((off, _),) = frag_b_rows(dh, lane, n, ks)
                assert [at[off + i] for i in range(4)] == [(8 * n + g, 8 * ks + 2 * t, 0), (8 * n + g, 8 * ks + 2 * t, 1),
                                                           (8 * n + g, 8 * ks + 2 * t + 1, 0),
                                                           (8 * n + g, 8 * ks + 2 * t + 1, 1)]
            for r0 in (0, 16, 48):
                (x, _), (y, _) = frag_a(dh, lane, r0, ks)
                for off, row in ((x, r0 + g), (y, r0 + g + 8)):
                    assert [at[off + i] for i in range(4)] == [(row, 8 * ks + 2 * t, 0), (row, 8 * ks + 2 * t, 1),
                                                               (row, 8 * ks + 2 * t + 1, 0),
                                                               (row, 8 * ks + 2 * t + 1, 1)]
        for j in range(4):
            for n in range(dh // 8):
                (lo, _), (hi, _) = frag_b_cols(dh, lane, j, n)
                for off, row in ((lo, 8 * j + 2 * t), (hi, 8 * j + 2 * t + 1)):
                    assert [at[off], at[off + 1]] == [(row, 8 * n + g, 0), (row, 8 * n + g, 1)]


@pytest.mark.parametrize("dh", [32, 64, 128])
def test_split_tile_loads_and_stores_are_free_of_bank_conflicts(dh):
    """Every warp-wide fragment load (each k8 step, n8 tile and row block
    the kernels use, at this width's row length) and every warp's stores in
    `split_tile` hit 32 distinct banks a phase."""
    for ks in range(dh // 8):
        for n in range(8):
            assert conflict_free([frag_b_rows(dh, lane, n, ks)[0] for lane in range(32)]), ("rows", ks, n)
        for r0 in (0, 16, 32, 48):
            for i in range(2):
                assert conflict_free([frag_a(dh, lane, r0, ks)[i] for lane in range(32)]), ("a", ks, r0, i)
    for j in range(8):
        for n in range(dh // 8):
            for i in range(2):
                assert conflict_free([frag_b_cols(dh, lane, j, n)[i] for lane in range(32)]), ("cols", j, n, i)
    stores = split_tile_stores(dh, 64)
    for j in range(64 * dh // 4 // THREADS):
        for warp in range(THREADS // 32):
            for i in range(2):
                assert conflict_free([(stores[j, 32 * warp + lane][i][0], 4) for lane in range(32)]), ("store", j, i)


def swz_raw(r):
    return (r & 3) << 1


def load_raw_swz_stores(dh, rows):
    """`load_raw<kDh, kRows, true>`: per (iteration j, thread i) its 16-byte
    copy, (float offset, [(row, column)] of its 4 floats)."""
    out = {}
    for j in range(rows * dh // 4 // THREADS):
        for tid in range(THREADS):
            i = tid + j * THREADS
            r, c = i // (dh // 4), i % (dh // 4)
            out[j, tid] = (r * dh + 4 * (c ^ swz_raw(r)), [(r, 4 * c + k) for k in range(4)])
    return out


def frag_a_raw(dh, lane, r0, ks):
    """The two 8-byte loads of `frag_a_raw`: row r0 + g, then r0 + g + 8, columns 8 ks + 2t and + 1."""
    g, t = lane // 4, lane % 4
    return [((r0 + g + 8 * r) * dh + 4 * ((2 * ks + t // 2) ^ swz_raw(r0 + g + 8 * r)) + 2 * (t & 1), 2)
            for r in range(2)]


def test_raw_kv_tiles_at_dh_128_are_read_without_bank_conflicts():
    """At dh 128 the dk/dv kernel keeps K and V raw: the swizzled copy is a
    bijection onto the 64 x 128 tile, every `frag_a_raw` load reads rows
    r0 + g and r0 + g + 8 at columns 8 ks + 2t and + 1, and its loads and
    the copy's 16-byte stores hit distinct banks a phase."""
    dh = 128
    stores = load_raw_swz_stores(dh, 64)
    at = {}
    for off, cols in stores.values():
        for k, key in enumerate(cols):
            assert off + k not in at
            at[off + k] = key
    assert sorted(at) == list(range(64 * dh))
    for j in range(64 * dh // 4 // THREADS):
        for warp in range(THREADS // 32):
            assert conflict_free([(stores[j, 32 * warp + lane][0], 4) for lane in range(32)]), ("store", j)
    for ks in range(dh // 8):
        for r0 in (0, 16, 32, 48):
            loads = [frag_a_raw(dh, lane, r0, ks) for lane in range(32)]
            for lane, pair in enumerate(loads):
                g, t = lane // 4, lane % 4
                for (off, _), row in zip(pair, (r0 + g, r0 + g + 8)):
                    assert [at[off], at[off + 1]] == [(row, 8 * ks + 2 * t), (row, 8 * ks + 2 * t + 1)]
            for i in range(2):
                assert conflict_free([pair[i] for pair in loads]), ("raw a", ks, r0, i)
