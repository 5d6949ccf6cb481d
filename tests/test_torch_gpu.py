"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`; each test asks the `cuda` fixture for the card and skips
without one, so every pytest worker collects the same tests. Run on a
machine with an H100 from the repo root (tests/conftest.py imports JAX,
which the port does not need):

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: fp32 1e-4 absolute (summation order); bf16
|kernel - plain| <= 2^-8·max|v| + 2^-7·|plain| elementwise (the plain
version rounds each probability to bf16 before the value product, as the
TPU kernel did, where the kernel keeps it in fp32 — kernel 5 in bf16
rounds the unnormalised exp(s - m) instead, at most 2^-9·max|v| an output;
each output is rounded once to bf16). The residuals and the backward's fp32 outputs (kernel and
plain version both compute in fp32 from the same inputs, summing up to G·S
terms in another order): 1e-4 of the tensor's largest entry; dq in bf16
adds 2^-7·|plain|, one bf16 rounding step apart. The quantized-cache
kernels (decode_attn_q, blockwise_causal_prefix_attn_q) and their plain
versions read identical int8/fp8 codes and scales and compute in fp32: the
same bounds, the bf16 one applying to a bf16 q's output. The exact form:
linformer_attn (kernel 5) under the attention bounds above; seq_projection
(kernel 6, fp32 sums of the same inputs, one rounding to the output dtype)
and the exact form's gradients under the backward's bounds. The MoE layer
(plain torch on the card, no kernel of its own): in fp32 the same routes
and drops as on the CPU and outputs within 1e-5; in bf16 two calls
bit-identical."""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.cache import (dequantize_blockwise,
                                    quantize_blockwise, resolve_page_dtype)
from repro_torch.core.causal import NEG_INF, compress_blocks
from repro_torch.core.projections import effective_k
from repro_torch.kernels import blockwise_causal_attn as bca
from repro_torch.kernels import linformer_attn as la
from repro_torch.kernels import ops as tops
from repro_torch.kernels import seq_projection as sp
from repro_torch.configs.base import MLPConfig, MoEConfig
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.models.transformer import flatten
from repro_torch.serving import ServingEngine

pytestmark = pytest.mark.gpu


def _assert_close(out, ref, values):
    diff = (out.float() - ref.float()).abs()
    if out.dtype == torch.float32:
        bound = torch.full_like(diff, 1e-4)
    else:
        vmax = max(v.float().abs().max().item() for v in values
                   if v.numel())          # an empty slot buffer (M = 0)
        bound = 2 ** -8 * vmax + 2 ** -7 * ref.float().abs()
    assert (diff <= bound).all(), diff.max().item()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _bca_inputs(B, H, Hkv, S, c, r, Dh, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, S, H, Dh, generator=g, device=dev).to(dtype)
    k = torch.randn(B, S, Hkv, Dh, generator=g, device=dev).to(dtype)
    v = torch.randn(B, S, Hkv, Dh, generator=g, device=dev).to(dtype)
    E = torch.randn(c, r, generator=g, device=dev) * r ** -0.5
    nb = S // c
    kbar = compress_blocks(k.reshape(B, nb, c, Hkv, Dh), E)
    vbar = compress_blocks(v.reshape(B, nb, c, Hkv, Dh), E)
    tk = lambda x: x.movedim(2, 1)  # noqa: E731  model -> kernel layout
    return (tk(q), tk(k), tk(v), tk(kbar.reshape(B, nb * r, Hkv, Dh)),
            tk(vbar.reshape(B, nb * r, Hkv, Dh)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 4, 2, 64, 16, 4, 16),
                                   (1, 32, 8, 1024, 256, 16, 128)],
                         ids=["smoke", "full"])
def test_blockwise_kernel_matches_plain(cuda, dtype, shape):
    B, H, Hkv, S, c, r, Dh = shape
    args = _bca_inputs(B, H, Hkv, S, c, r, Dh, dtype, cuda)
    kw = dict(block_size=c, block_slots=r, scale=Dh ** -0.5)
    n0 = bca.blockwise_causal_attn.launches
    out = bca.blockwise_causal_attn(*args, **kw)
    torch.cuda.synchronize()
    assert bca.blockwise_causal_attn.launches == n0 + 1
    ref = bca.blockwise_causal_attn_plain(*args, **kw)
    assert out.dtype == dtype and out.shape == ref.shape
    _assert_close(out, ref, (args[2], args[4]))


def _assert_grad_close(out, ref):
    diff = (out.float() - ref.float()).abs()
    bound = 1e-4 * max(1.0, ref.float().abs().max().item())
    if out.dtype == torch.bfloat16:
        bound = bound + 2 ** -7 * ref.float().abs()
    assert (diff <= bound).all(), diff.max().item()


BWD_SHAPES = {"smoke_gqa_2c": ((2, 4, 2, 32, 16, 4, 16), None),
              "smoke_offset": ((2, 4, 2, 32, 16, 4, 16), [1, 3]),
              # the train step's shapes (qwen3-8b, B=2, S=4096)
              "full": ((2, 32, 8, 4096, 256, 16, 128), None)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ["smoke_gqa_2c", "full"])
def test_residual_forward_matches_plain(cuda, dtype, shape):
    (B, H, Hkv, S, c, r, Dh), _ = BWD_SHAPES[shape]
    args = _bca_inputs(B, H, Hkv, S, c, r, Dh, dtype, cuda, seed=2)
    kw = dict(block_size=c, block_slots=r, scale=Dh ** -0.5)
    n0 = bca.blockwise_causal_attn.residual_launches
    out, m, d = bca.blockwise_causal_attn(*args, return_residuals=True, **kw)
    torch.cuda.synchronize()
    assert bca.blockwise_causal_attn.residual_launches == n0 + 1
    ro, rm, rd = bca.blockwise_causal_attn_plain(*args, return_residuals=True,
                                                 **kw)
    _assert_close(out, ro, (args[2], args[4]))
    _assert_grad_close(m, rm)
    _assert_grad_close(d, rd)
    # one build serves both forms: the plain form's output is the same
    assert torch.equal(bca.blockwise_causal_attn(*args, **kw), out)


def _offset_residuals(q, k, kbar, start, kw):
    """(m, denom) of the offset form, from the joint scores."""
    nb = q.shape[2] // kw["block_size"]
    cut = torch.arange(nb, device=q.device)[None] + start.long()[:, None]
    s_loc, s_glob = bca.joint_scores(q, k, kbar, cut, **kw)
    m = torch.maximum(s_loc.amax(-1, keepdim=True),
                      s_glob.amax(-1, keepdim=True))
    d = (torch.exp(s_loc - m).sum(-1, keepdim=True)
         + torch.exp(s_glob - m).sum(-1, keepdim=True))
    shape = q.shape[:3]
    return m.reshape(shape).contiguous(), d.reshape(shape).contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", list(BWD_SHAPES))
def test_backward_kernel_matches_plain(cuda, dtype, shape):
    (B, H, Hkv, S, c, r, Dh), start = BWD_SHAPES[shape]
    q, k, v, kb, vb = _bca_inputs(B, H, Hkv, S, c, r, Dh, dtype, cuda,
                                  seed=3)
    kw = dict(block_size=c, block_slots=r, scale=Dh ** -0.5)
    sb = None
    if start is None:
        _, m, d = bca.blockwise_causal_attn_plain(q, k, v, kb, vb,
                                                  return_residuals=True, **kw)
    else:
        # a full slot buffer: the slots of earlier chunks, then this one's
        sb = torch.tensor(start, dtype=torch.int32, device=cuda)
        g = torch.Generator(device=cuda).manual_seed(4)
        kb, vb = (torch.cat([torch.randn(B, Hkv, max(start) * r, Dh,
                                         generator=g, device=cuda).to(dtype),
                             x], 2) for x in (kb, vb))
        m, d = _offset_residuals(q, k, kb, sb, kw)
    g = torch.Generator(device=cuda).manual_seed(5)
    do = torch.randn(q.shape, generator=g, device=cuda).to(dtype)
    n0 = bca.blockwise_causal_attn_bwd.launches
    got = bca.blockwise_causal_attn_bwd(q, k, v, kb, vb, m, d, do,
                                        start_blocks=sb, **kw)
    torch.cuda.synchronize()
    assert bca.blockwise_causal_attn_bwd.launches == n0 + 1
    want = bca.blockwise_causal_attn_bwd_plain(q, k, v, kb, vb, m, d, do,
                                               start_blocks=sb, **kw)
    assert got[0].dtype == dtype
    for g_, w in zip(got, want):
        assert g_.shape == w.shape
        _assert_grad_close(g_, w)
    # slots no row sees (block >= start + S/c - 1) are exact zeros
    nb0 = torch.zeros(B, device=cuda) if sb is None else sb
    slot_blk = torch.arange(kb.shape[2], device=cuda) // r
    invisible = slot_blk[None] >= (nb0[:, None] + S // c - 1)
    assert invisible.any()
    for g_ in got[3:]:
        assert torch.all(g_.movedim(1, 2)[invisible] == 0)


def test_autograd_through_kernels_matches_reference(cuda):
    """Gradients through the port's Function (residual forward + backward
    kernel) against autograd through the plain reference form, fp32."""
    g = torch.Generator(device=cuda).manual_seed(5)
    B, H, Hkv, S, c, r, Dh = 2, 8, 2, 128, 32, 8, 32
    xs = [torch.randn(*shape, generator=g, device=cuda).requires_grad_()
          for shape in ((B, S, H, Dh), (B, S, Hkv, Dh), (B, S, Hkv, Dh),
                        (c, r), (c, r))]
    do = torch.randn(B, S, H, Dh, generator=g, device=cuda)
    kw = dict(block_size=c, block_slots=r, scale=Dh ** -0.5)
    grads = {}
    for impl in ("fused", "reference"):
        n0 = bca.blockwise_causal_attn_bwd.launches
        out = tops.fused_blockwise_causal_attention(*xs, backward_impl=impl,
                                                    **kw)
        grads[impl] = torch.autograd.grad(out, xs, do)
        assert (bca.blockwise_causal_attn_bwd.launches > n0) == \
            (impl == "fused")
    for a, b_ in zip(grads["fused"], grads["reference"]):
        _assert_grad_close(a, b_)


def _decode_inputs(B, Hkv, G, c, M, r, Dh, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, Hkv, G, Dh, generator=g, device=dev).to(dtype)
    ring = [torch.randn(B, c, Hkv, Dh, generator=g,
                        device=dev).to(dtype).movedim(2, 1)
            for _ in range(2)]
    slots = [torch.randn(B, M, Hkv, Dh, generator=g,
                         device=dev).to(dtype).movedim(2, 1)
             for _ in range(2)]
    t = torch.randint(0, (M // r) * c, (B,), generator=g, device=dev)
    t[0] = 0                                     # pos 0, no visible slot
    if B > 1:
        t[1] = c - 1                             # pos c-1, no visible slot
    bl = torch.where(torch.arange(c, device=dev)[None] <= (t % c)[:, None],
                     0.0, NEG_INF)
    bg = torch.where(torch.arange(M, device=dev)[None] < (t // c * r)[:, None],
                     0.0, NEG_INF)
    return (q, *ring, *slots, bl.float(), bg.float())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 2, 2, 16, 24, 4, 16),
                                   (4, 8, 4, 256, 256, 16, 128)],
                         ids=["smoke", "full"])
def test_decode_kernel_matches_plain(cuda, dtype, shape):
    B, Hkv, G, c, M, r, Dh = shape
    args = _decode_inputs(B, Hkv, G, c, M, r, Dh, dtype, cuda)
    n0 = la.decode_attn.launches
    out = la.decode_attn(*args, scale=Dh ** -0.5)
    torch.cuda.synchronize()
    assert la.decode_attn.launches == n0 + 1
    ref = la.decode_attn_plain(*args, scale=Dh ** -0.5)
    assert out.dtype == dtype and out.shape == ref.shape
    _assert_close(out, ref, (args[2], args[4]))


def test_smoke_serving_through_kernels_matches_reference(cuda):
    cfg = dataclasses.replace(get_smoke_config("qwen3-8b"), dtype="float32")
    params = tmodel.init_params(cfg, seed=0, device=cuda)
    prompts = [[5 + i] * n for i, n in enumerate([8, 19, 35, 48])]
    outs = {}
    for backend in ("auto", "reference"):
        eng = ServingEngine(params, cfg, max_seq=96, device=cuda,
                            cache_dtype=torch.float32, decode_chunk=4,
                            attention_backend=backend)
        n_bca = bca.blockwise_causal_attn.launches
        n_dec = la.decode_attn.launches
        outs[backend] = eng.serve(prompts, 20, max_batch=3)
        launched = (bca.blockwise_causal_attn.launches > n_bca,
                    la.decode_attn.launches > n_dec)
        assert launched == ((True, True) if backend == "auto"
                            else (False, False))
    assert outs["auto"] == outs["reference"]


# prefix form: (B, H, Hkv, P, c, r, Dh), per-row start blocks, slot buffer M,
# edge; smoke's last row is clamped at M (its cut (9 + 2)·4 = 44 > 40). The
# rest are chip_smoke's PREFIX_EDGE_SHAPES: the bf16 kernel's 64-row query
# tile spans 4, 2 or non-dividing blocks at c = 16, 32, 48 (c16's second
# tile ragged, its row 1 clamped at M), G = 1, 3, 6, M = 0, a start block at
# M/r - 1, every operand one element into its buffer (no 16-byte loads),
# and the dense configs' G = 2, 5 (one head a block), 8 at c = 256, Dh = 128
PREFIX_SHAPES = {
    "smoke": ((3, 4, 2, 32, 16, 4, 16), [0, 5, 9], 40, None),
    "full": ((4, 32, 8, 512, 256, 16, 128), [0, 3, 7, 14], 288, None),
    "c16_dh16_g1": ((2, 2, 2, 96, 16, 4, 16), [0, 9], 48, None),
    "c32_dh32_g3": ((2, 6, 2, 128, 32, 8, 32), [2, 7], 120, None),
    "c48_dh64": ((2, 4, 2, 144, 48, 4, 64), [1, 6], 64, None),
    "c64_dh64_g6": ((1, 12, 2, 192, 64, 8, 64), [4], 200, None),
    "m0": ((2, 4, 2, 64, 16, 4, 32), [0, 3], 0, None),
    "last_start": ((2, 4, 2, 64, 32, 8, 64), [7, 0], 64, None),
    "shifted": ((2, 4, 2, 64, 16, 4, 64), [1, 2], 24, "shifted"),
    "g2_c256_dh128": ((2, 4, 2, 512, 256, 16, 128), [0, 5], 288, None),
    "g5_c256_dh128": ((2, 10, 2, 512, 256, 16, 128), [3, 16], 288, None),
    "g8_c256_dh128": ((2, 16, 2, 512, 256, 16, 128), [1, 9], 288, None),
}


def _prefix_inputs(shape, start, M, dtype, dev, seed=6):
    B, H, Hkv, P, c, r, Dh = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, H, P, Dh, generator=g, device=dev).to(dtype)
    k, v = (torch.randn(B, Hkv, P, Dh, generator=g, device=dev).to(dtype)
            for _ in range(2))
    ck, cv = (torch.randn(B, Hkv, M, Dh, generator=g, device=dev) * 2
              for _ in range(2))
    return q, k, v, ck, cv, torch.tensor(start, dtype=torch.int32,
                                         device=dev)


def _quantized(x, page_dtype):
    """Kernel-layout (B, Hkv, N, Dh) fp32 -> codes and (B, Hkv, N) scales."""
    pdt, qmax = resolve_page_dtype(page_dtype)
    return quantize_blockwise(x, (3,), dtype=pdt, qmax=qmax)


def _prefix_case(shape, dtype, storage, dev, seed=6):
    """(wrapper, plain twin, args, value operands) of kernel 4 (storage
    "dense") or kernel 8 (int8 / fp8 codes) at one PREFIX_SHAPES entry,
    every operand moved into its buffer by one element for "shifted"."""
    dims, start, M, edge = PREFIX_SHAPES[shape]
    move = _shifted if edge == "shifted" else (lambda x: x)
    q, k, v, ck, cv, sb = _prefix_inputs(dims, start, M, dtype, dev, seed)
    q, k, v = move(q), move(k), move(v)
    if storage == "dense":
        ck, cv = move(ck.to(dtype)), move(cv.to(dtype))
        return (bca.blockwise_causal_prefix_attn,
                bca.blockwise_causal_attn_plain, (q, k, v, ck, cv, sb),
                (v, cv))
    (ck, cks), (cv, cvs) = _quantized(ck, storage), _quantized(cv, storage)
    args = (q, k, v, move(ck), move(cv), move(cks), move(cvs), sb)
    return (bca.blockwise_causal_prefix_attn_q,
            bca.blockwise_causal_prefix_attn_q_plain, args,
            (v, dequantize_blockwise(cv, cvs)))


def _prefix_kw(shape):
    c, r, Dh = PREFIX_SHAPES[shape][0][4:]
    return dict(block_size=c, block_slots=r, scale=Dh ** -0.5)


@pytest.mark.parametrize("residuals", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", list(PREFIX_SHAPES))
def test_prefix_kernel_matches_plain(cuda, shape, dtype, residuals):
    fn, _, args, values = _prefix_case(shape, dtype, "dense", cuda)
    kw = dict(_prefix_kw(shape), return_residuals=residuals)
    n0 = fn.residual_launches if residuals else fn.launches
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    assert (fn.residual_launches if residuals else fn.launches) == n0 + 1
    want = bca.blockwise_causal_attn_plain(*args[:5], start_blocks=args[5],
                                           **kw)
    if not residuals:
        got, want = (got,), (want,)
    assert got[0].dtype == dtype
    _assert_close(got[0], want[0], values)
    for g_, w in zip(got[1:], want[1:]):
        _assert_grad_close(g_, w)


@pytest.mark.parametrize("page_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", list(PREFIX_SHAPES))
def test_prefix_q_kernel_matches_plain(cuda, shape, dtype, page_dtype):
    fn, plain, args, values = _prefix_case(shape, dtype, page_dtype, cuda)
    kw = _prefix_kw(shape)
    n0 = fn.launches
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    ref = plain(*args, **kw)
    assert out.dtype == dtype and out.shape == ref.shape
    _assert_close(out, ref, values)


@pytest.mark.parametrize("storage", ["dense", "int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefix_kernels_are_deterministic(cuda, dtype, storage):
    """Two launches of kernel 4 (both forms) or kernel 8 at the chunk
    forward's full shape give the same bits: no atomics."""
    fn, _, args, _ = _prefix_case("full", dtype, storage, cuda)
    kw = _prefix_kw("full")
    forms = [dict(return_residuals=True)] if storage == "dense" else []
    for extra in [{}] + forms:
        a, b = fn(*args, **kw, **extra), fn(*args, **kw, **extra)
        torch.cuda.synchronize()
        for x, y in zip(*((a, b) if extra else ((a,), (b,)))):
            assert torch.equal(x, y)


@pytest.mark.parametrize("storage", ["dense", "int8"])
def test_prefix_kernels_replay_from_a_cuda_graph(cuda, storage):
    """Kernel 4 (both forms) or kernel 8 in bf16 captured into a CUDA graph
    (start blocks read on the device, no host sync, outputs from the
    caching allocator) and replayed equals the eager call."""
    fn, _, args, _ = _prefix_case("full", torch.bfloat16, storage, cuda)
    kw = _prefix_kw("full")
    forms = [{}] + ([dict(return_residuals=True)] if storage == "dense"
                    else [])
    for extra in forms:
        eager = fn(*args, **kw, **extra)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn(*args, **kw, **extra)
        graph.replay()
        torch.cuda.synchronize()
        for x, y in zip(*((out, eager) if extra else ((out,), (eager,)))):
            assert torch.equal(x, y)


# (wrapper call, dtype) -> the kernel it must launch: bf16 (kernels 1, 1r
# of the training form; 4, 4r, 8 with start blocks) the tensor-core kernel,
# fp32 the SIMT kernel
BCA_ROUTES = {
    ("prefix", torch.bfloat16): "tensor cores",
    ("prefix_res", torch.bfloat16): "tensor cores",
    ("prefix_q", torch.bfloat16): "tensor cores",
    ("prefix", torch.float32): "simt",
    ("prefix_res", torch.float32): "simt",
    ("prefix_q", torch.float32): "simt",
    ("blockwise", torch.bfloat16): "tensor cores",
    ("blockwise_res", torch.bfloat16): "tensor cores",
    ("blockwise", torch.float32): "simt",
    ("blockwise_res", torch.float32): "simt",
}


@pytest.mark.parametrize("call,dtype", list(BCA_ROUTES),
                         ids=[f"{c}-{str(d)[6:]}" for c, d in BCA_ROUTES])
def test_forward_kernels_run_their_routes_design(cuda, call, dtype):
    """bf16 calls launch the tensor-core kernel, with start blocks or
    without; fp32 calls the SIMT kernel (the library's route probe, read
    after each launch)."""
    if call.startswith("prefix"):
        storage = "int8" if call == "prefix_q" else "dense"
        fn, _, args, _ = _prefix_case("smoke", dtype, storage, cuda)
        kw = dict(_prefix_kw("smoke"))
        if call == "prefix_res":
            kw["return_residuals"] = True
    else:
        fn = bca.blockwise_causal_attn
        args = _bca_inputs(2, 4, 2, 64, 16, 4, 16, dtype, cuda)
        kw = dict(block_size=16, block_slots=4, scale=0.25,
                  return_residuals=call == "blockwise_res")
    other = "simt" if BCA_ROUTES[call, dtype] != "simt" else "tensor cores"
    # a launch of the other route first, so the probe must change
    if other == "simt":
        bca.blockwise_causal_attn(*_bca_inputs(2, 4, 2, 64, 16, 4, 16,
                                               torch.float32, cuda),
                                  block_size=16, block_slots=4, scale=0.25)
    else:
        f2, _, a2, _ = _prefix_case("smoke", torch.bfloat16, "dense", cuda)
        f2(*a2, **_prefix_kw("smoke"))
    assert bca.last_forward_route() == other
    fn(*args, **kw)
    torch.cuda.synchronize()
    assert bca.last_forward_route() == BCA_ROUTES[call, dtype]


# quantized decode: (B, Hkv, G, c, M, r, Dh) and the rows' positions
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernels_run_their_routes_design(cuda, dtype):
    """Kernel 2 in bf16 launches the tensor-core kernels, in fp32 the SIMT
    kernels (the library's backward route probe, read after each launch,
    a launch of the other route first)."""
    want = "tensor cores" if dtype == torch.bfloat16 else "simt"
    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    kw = dict(block_size=16, block_slots=4, scale=0.25)
    for dt in (other, dtype):
        q, k, v, kb, vb = _bca_inputs(2, 4, 2, 64, 16, 4, 16, dt, cuda)
        _, m, d = bca.blockwise_causal_attn(q, k, v, kb, vb,
                                            return_residuals=True, **kw)
        bca.blockwise_causal_attn_bwd(q, k, v, kb, vb, m, d, q, **kw)
        torch.cuda.synchronize()
    assert bca.last_backward_route() == want
    assert bca.last_forward_route() == want


# the training form's edges (chip_smoke's TRAIN_EDGE_SHAPES): (B, H, Hkv, S,
# c, r, Dh), per-row start blocks, edge. The tensor-core kernels' 64-row and
# 64-key tiles span 4 blocks at c = 16 (a ragged S of 96), 2 at c = 32, and
# blocks that do not divide them at c = 48 (a ragged S of 144); G = 1, 3, 6;
# Dh 16-128; S = 1024 gives each slot tile two row splits, the first of
# slot tiles 2 and 3 empty; shifted: q, k, v, slots and dO one element into
# their buffers; the dense configs' G = 2, 5, 8 at c = 256, Dh = 128 (G = 5
# also with a start block) and musicgen-large's G = 1 at Dh = 64
TRAIN_EDGES = {
    "c16_dh16_g1": ((2, 2, 2, 96, 16, 4, 16), None, None),
    "c32_dh32_g3": ((2, 6, 2, 128, 32, 8, 32), None, None),
    "c48_dh64": ((2, 4, 2, 144, 48, 4, 64), None, None),
    "c64_dh64_g6": ((1, 12, 2, 192, 64, 8, 64), None, None),
    "split_empty_dh128": ((1, 4, 2, 1024, 64, 16, 128), None, None),
    "offset_c16_ragged": ((2, 4, 2, 96, 16, 4, 32), [0, 5], None),
    "offset_g6": ((1, 12, 2, 192, 64, 8, 64), [2], None),
    "shifted": ((2, 4, 2, 64, 16, 4, 64), None, "shifted"),
    "shifted_offset": ((2, 4, 2, 64, 16, 4, 64), [1, 2], "shifted"),
    "g2_c256_dh128": ((1, 4, 2, 1024, 256, 16, 128), None, None),
    "g5_c256_dh128": ((1, 10, 2, 1024, 256, 16, 128), None, None),
    "g8_c256_dh128": ((1, 16, 2, 1024, 256, 16, 128), None, None),
    "g1_c256_dh64": ((2, 4, 4, 1024, 256, 16, 64), None, None),
    "g5_c256_offset": ((1, 10, 2, 1024, 256, 16, 128), [3], None),
}


def _train_edge_case(name, dtype, dev):
    """Kernel-layout operands of one edge (slots of earlier chunks put
    before the chunk's own for start blocks), residuals of the forward's
    plain twin, a dO, the start blocks, the keyword arguments."""
    (B, H, Hkv, S, c, r, Dh), start, edge = TRAIN_EDGES[name]
    q, k, v, kb, vb = _bca_inputs(B, H, Hkv, S, c, r, Dh, dtype, dev, seed=3)
    kw = dict(block_size=c, block_slots=r, scale=Dh ** -0.5)
    sb = None
    if start is not None:
        sb = torch.tensor(start, dtype=torch.int32, device=dev)
        g = torch.Generator(device=dev).manual_seed(4)
        kb, vb = (torch.cat([torch.randn(B, Hkv, max(start) * r, Dh,
                                         generator=g, device=dev).to(dtype),
                             x], 2) for x in (kb, vb))
        m, d = _offset_residuals(q, k, kb, sb, kw)
    else:
        _, m, d = bca.blockwise_causal_attn_plain(q, k, v, kb, vb,
                                                  return_residuals=True, **kw)
    g = torch.Generator(device=dev).manual_seed(5)
    do = torch.randn(q.shape, generator=g, device=dev).to(dtype)
    if edge == "shifted":
        q, k, v, kb, vb, do = map(_shifted, (q, k, v, kb, vb, do))
    return (q, k, v, kb, vb), m, d, do, sb, kw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", [n for n in TRAIN_EDGES
                                  if TRAIN_EDGES[n][1] is None])
def test_training_forward_at_its_edges(cuda, name, dtype):
    """Kernels 1 and 1r against their plain twin, two launches bit-identical,
    the plain form's output the residual form's."""
    args, _, _, _, _, kw = _train_edge_case(name, dtype, cuda)
    out, m, d = bca.blockwise_causal_attn(*args, return_residuals=True, **kw)
    again = bca.blockwise_causal_attn(*args, return_residuals=True, **kw)
    plain = bca.blockwise_causal_attn(*args, **kw)
    torch.cuda.synchronize()
    ro, rm, rd = bca.blockwise_causal_attn_plain(*args, return_residuals=True,
                                                 **kw)
    _assert_close(out, ro, (args[2], args[4]))
    _assert_grad_close(m, rm)
    _assert_grad_close(d, rd)
    assert all(torch.equal(a, b) for a, b in zip(again, (out, m, d)))
    assert torch.equal(plain, out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(TRAIN_EDGES))
def test_backward_kernel_at_its_edges(cuda, name, dtype):
    """Kernel 2 against its plain twin, two launches bit-identical, exact
    zeros on the slots no row sees."""
    args, m, d, do, sb, kw = _train_edge_case(name, dtype, cuda)
    got = bca.blockwise_causal_attn_bwd(*args, m, d, do, start_blocks=sb,
                                        **kw)
    again = bca.blockwise_causal_attn_bwd(*args, m, d, do, start_blocks=sb,
                                          **kw)
    torch.cuda.synchronize()
    want = bca.blockwise_causal_attn_bwd_plain(*args, m, d, do,
                                               start_blocks=sb, **kw)
    for g_, w in zip(got, want):
        assert g_.shape == w.shape
        _assert_grad_close(g_, w)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    (B, _, _, S, c, r, _), _, _ = TRAIN_EDGES[name]
    nb0 = torch.zeros(B, device=cuda) if sb is None else sb
    slot_blk = torch.arange(args[3].shape[2], device=cuda) // r
    invisible = slot_blk[None] >= (nb0[:, None] + S // c - 1)
    assert invisible.any()
    for g_ in got[3:]:
        assert torch.all(g_.movedim(1, 2)[invisible] == 0)


def test_backward_kernel_replays_from_a_cuda_graph(cuda):
    """Kernel 2 in bf16 at the train step's shapes captured into a CUDA
    graph (no host sync; outputs and the slot splits' scratch from the
    caching allocator) and replayed equals the eager launch."""
    (B, H, Hkv, S, c, r, Dh), _ = BWD_SHAPES["full"]
    args = _bca_inputs(B, H, Hkv, S, c, r, Dh, torch.bfloat16, cuda, seed=7)
    kw = dict(block_size=c, block_slots=r, scale=Dh ** -0.5)
    _, m, d = bca.blockwise_causal_attn(*args, return_residuals=True, **kw)
    g = torch.Generator(device=cuda).manual_seed(8)
    do = torch.randn(args[0].shape, generator=g, device=cuda).to(
        torch.bfloat16)
    eager = bca.blockwise_causal_attn_bwd(*args, m, d, do, **kw)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = bca.blockwise_causal_attn_bwd(*args, m, d, do, **kw)
    graph.replay()
    torch.cuda.synchronize()
    for x, y in zip(out, eager):
        assert torch.equal(x, y)


DECODE_Q_SHAPES = {"smoke": ((4, 2, 2, 16, 24, 4, 16), [0, 15, 23, 95]),
                   "full": ((4, 8, 4, 256, 288, 16, 128),
                            [300, 1000, 2300, 4000])}


@pytest.mark.parametrize("page_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", list(DECODE_Q_SHAPES))
def test_decode_q_kernel_matches_plain(cuda, shape, dtype, page_dtype):
    (B, Hkv, G, c, M, r, Dh), t = DECODE_Q_SHAPES[shape]
    g = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn(B, Hkv, G, Dh, generator=g, device=cuda).to(dtype)
    ops = [_quantized(torch.randn(B, Hkv, n, Dh, generator=g, device=cuda),
                      page_dtype) for n in (c, c, M, M)]
    t = torch.tensor(t, device=cuda)
    bl = torch.where(torch.arange(c, device=cuda)[None] <= (t % c)[:, None],
                     0.0, NEG_INF).float()
    bg = torch.where(torch.arange(M, device=cuda)[None]
                     < (t // c * r)[:, None], 0.0, NEG_INF).float()
    args = (q, *(x for x, _ in ops), *(s_ for _, s_ in ops), bl, bg)
    n0 = la.decode_attn_q.launches
    out = la.decode_attn_q(*args, scale=Dh ** -0.5)
    torch.cuda.synchronize()
    assert la.decode_attn_q.launches == n0 + 1
    ref = la.decode_attn_q_plain(*args, scale=Dh ** -0.5)
    assert out.dtype == dtype and out.shape == ref.shape
    _assert_close(out, ref, [dequantize_blockwise(*ops[i]) for i in (1, 3)])


# the decode kernels' edges: (B, Hkv, G, c, M, r, Dh), rows' positions,
# edge. b1_split_empty: a B = 1 step at t = 10, so 7 of its 8 key splits
# see no visible key and their 64-key tiles are skipped; b4_full: B = 4 at
# pos 0, c - 1 and block boundaries; ragged_dh64: c + M = 300, not a
# multiple of the tile; masked_row_dh16: row 1 masks every key (the plain
# version's uniform average); shifted_dh64: ring and slots one element
# into their buffers (no 16-byte loads), G = 3; g6_dh32: G = 6, two
# blocks of query rows a kv head; the dense configs' G = 2 (a half-filled
# block of four query rows), 5 (blocks of four and one), 8 at Dh = 128 and
# musicgen-large's G = 1 at Dh = 64
DECODE_EDGES = {
    "b1_split_empty": ((1, 8, 4, 256, 256, 16, 128), [10], None),
    "b4_full": ((4, 8, 4, 256, 256, 16, 128), [0, 255, 1380, 4095], None),
    "ragged_dh64": ((2, 2, 4, 100, 200, 4, 64), [150, 2410], None),
    "masked_row_dh16": ((4, 2, 2, 16, 24, 4, 16), [0, 15, 23, 95],
                        "masked_row"),
    "shifted_dh64": ((2, 2, 3, 64, 70, 8, 64), [70, 300], "shifted"),
    "g6_dh32": ((1, 2, 6, 64, 64, 8, 32), [100], None),
    "g2_c256_dh128": ((2, 2, 2, 256, 256, 16, 128), [300, 3000], None),
    "g5_c256_dh128": ((2, 2, 5, 256, 256, 16, 128), [700, 4000], None),
    "g8_c256_dh128": ((2, 2, 8, 256, 256, 16, 128), [255, 2048], None),
    "g1_c256_dh64": ((2, 4, 1, 256, 256, 16, 64), [10, 3900], None),
}


def _decode_edge_inputs(shape, t, edge, dtype, storage, dev, seed=9):
    """(wrapper, plain twin, operands, value operands) of kernel 3
    (storage "dense") or kernel 7 (int8 / fp8 codes) at one edge."""
    B, Hkv, G, c, M, r, Dh = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, Hkv, G, Dh, generator=g, device=dev).to(dtype)
    kv = [torch.randn(B, n, Hkv, Dh, generator=g, device=dev)
          for n in (c, c, M, M)]
    t = torch.tensor(t, device=dev)
    bl = torch.where(torch.arange(c, device=dev)[None] <= (t % c)[:, None],
                     0.0, NEG_INF).float()
    bg = torch.where(torch.arange(M, device=dev)[None]
                     < (t // c * r)[:, None], 0.0, NEG_INF).float()
    if edge == "masked_row":
        bl[1], bg[1] = NEG_INF, NEG_INF
    if storage == "dense":
        kv = [x.to(dtype) for x in kv]
        if edge == "shifted":
            kv = [_shifted(x) for x in kv]
        kv = [x.movedim(2, 1) for x in kv]
        return (la.decode_attn, la.decode_attn_plain, (q, *kv, bl, bg),
                (kv[1], kv[3]))
    ops = [_quantized(x.movedim(2, 1), storage) for x in kv]
    if edge == "shifted":
        ops = [(_shifted(x), sc) for x, sc in ops]
    args = (q, *(x for x, _ in ops), *(sc for _, sc in ops), bl, bg)
    return (la.decode_attn_q, la.decode_attn_q_plain, args,
            [dequantize_blockwise(*ops[i]) for i in (1, 3)])


@pytest.mark.parametrize("storage", ["dense", "int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("edge", list(DECODE_EDGES))
def test_decode_kernels_at_their_edges(cuda, edge, dtype, storage):
    """Kernels 3 and 7 against their plain twins at each edge; a second
    launch gives the same bits (the key splits merge in a fixed order)."""
    shape, t, kind = DECODE_EDGES[edge]
    fn, plain, args, values = _decode_edge_inputs(shape, t, kind, dtype,
                                                  storage, cuda)
    sc = shape[-1] ** -0.5
    n0 = fn.launches
    out = fn(*args, scale=sc)
    again = fn(*args, scale=sc)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 2
    ref = plain(*args, scale=sc)
    assert out.dtype == dtype and out.shape == ref.shape
    _assert_close(out, ref, values)
    assert torch.equal(out, again)


@pytest.mark.parametrize("storage", ["dense", "int8", "fp8"])
def test_decode_kernels_skip_masked_tiles(cuda, storage):
    """A B = 1 step at t = 10 sees ring keys 0..10 only: every other key of
    the ring and every slot is NaN (dense) or has a NaN scale (quantized),
    and the kernel, which skips the masked tiles and keys, returns the
    plain twin's output on the clean operands."""
    shape, t, _ = DECODE_EDGES["b1_split_empty"]
    fn, plain, args, values = _decode_edge_inputs(shape, t, None,
                                                  torch.bfloat16, storage,
                                                  cuda)
    sc = shape[-1] ** -0.5
    ref = plain(*args, scale=sc)
    poisoned = [x.clone() for x in args]
    if storage == "dense":
        for i in (1, 2):                        # ring k, v past key 10
            poisoned[i][:, :, t[0] + 1:] = float("nan")
        for i in (3, 4):                        # every slot
            poisoned[i][:] = float("nan")
    else:
        for i in (5, 6):                        # ring scales past key 10
            poisoned[i][:, :, t[0] + 1:] = float("nan")
        for i in (7, 8):                        # every slot scale
            poisoned[i][:] = float("nan")
    out = fn(*poisoned, scale=sc)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    assert torch.equal(out, fn(*args, scale=sc))
    _assert_close(out, ref, values)


@pytest.mark.parametrize("storage", ["dense", "int8"])
def test_decode_kernels_replay_from_a_cuda_graph(cuda, storage):
    """One decode call captured into a CUDA graph (split scratch from the
    caching allocator, no host sync) and replayed equals the eager call."""
    shape, t, _ = DECODE_EDGES["b4_full"]
    fn, _, args, _ = _decode_edge_inputs(shape, t, None, torch.bfloat16,
                                         storage, cuda)
    sc = shape[-1] ** -0.5
    eager = fn(*args, scale=sc)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*args, scale=sc)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


@pytest.mark.parametrize("mode", ["chunked", "paged-int8", "paged-fp8"])
def test_smoke_serving_modes_through_kernels_match_reference(cuda, mode):
    """SMOKE serve through the kernels against the reference route, chunked
    admission into the dense pool and the paged pool under chunked
    admission: identical greedy tokens, the mode's kernels launched."""
    cfg = dataclasses.replace(get_smoke_config("qwen3-8b"), dtype="float32")
    params = tmodel.init_params(cfg, seed=0, device=cuda)
    prompts = [[5 + i] * n for i, n in enumerate([8, 19, 35, 48, 70])]
    kw = dict(prefill_chunk=32)
    counters = [(bca.blockwise_causal_prefix_attn, "launches"),
                (la.decode_attn, "launches")]
    if mode != "chunked":
        kw.update(cache_format="paged", page_dtype=mode.split("-")[1])
        counters = [(bca.blockwise_causal_prefix_attn_q, "launches"),
                    (la.decode_attn_q, "launches")]
    outs = {}
    for backend in ("auto", "reference"):
        eng = ServingEngine(params, cfg, max_seq=96, device=cuda,
                            cache_dtype=torch.float32, decode_chunk=4,
                            attention_backend=backend, **kw)
        n0 = [getattr(f, a) for f, a in counters]
        outs[backend], sched = eng.serve(prompts, 20, max_batch=3,
                                         return_scheduler=True)
        launched = [getattr(f, a) > n for (f, a), n in zip(counters, n0)]
        assert launched == [backend == "auto"] * 2
        if mode != "chunked":
            sched.pool.alloc.check()
            assert sched.pool.alloc.free_pages == sched.pool.alloc.usable_pages
    assert outs["auto"] == outs["reference"]


# -- the exact form: kernels 5 and 6 ------------------------------------------

# (B, H, Hkv, S, K, Dh): K = 1; K = 512 at Dh = 128 (the most shared memory);
# a ragged S with GQA G = 2; the paper's full width; K = 130, 2 slots past
# one 128-slot tile of the bf16 kernel; Dh = 32 at K = 128; q starting one
# element into its buffer (EXACT_SHIFTED: not 16-byte aligned)
EXACT_SHAPES = {"k1": (1, 2, 2, 40, 1, 16),
                "k512_dh128": (1, 4, 4, 100, 512, 128),
                "ragged_gqa2": (2, 4, 2, 77, 40, 64),
                "full": (32, 12, 12, 512, 128, 64),
                "k130": (2, 4, 2, 100, 130, 64),
                "dh32_k128": (2, 4, 4, 128, 128, 32),
                "misaligned_q": (2, 4, 2, 77, 128, 64)}
EXACT_SHIFTED = {"misaligned_q": "q"}
# (B, H, S, K, Dh, rows of the stored E): E[:S] of a longer E; K past one
# slot tile; the paper's full width; K = 130, 2 slots past one 128-slot
# tile; K = 512 at Dh = 128; x or E starting one element into its buffer
# (SP_SHIFTED); a long S = 1100 (18 chunks, the last ragged)
SP_SHAPES = {"k1": (2, 4, 40, 1, 16, 40),
             "sliced_k70": (2, 2, 77, 70, 128, 100),
             "k512": (1, 2, 64, 512, 64, 64),
             "full": (32, 12, 512, 128, 64, 512),
             "k130": (2, 4, 100, 130, 64, 128),
             "k512_dh128": (1, 2, 130, 512, 128, 160),
             "misaligned_x": (2, 4, 77, 128, 64, 100),
             "misaligned_E": (2, 4, 77, 128, 64, 100),
             "s1100": (2, 4, 1100, 130, 64, 1200)}
SP_SHIFTED = {"misaligned_x": "x", "misaligned_E": "E"}


def _shifted(t):
    """t's values in a contiguous view starting one element into a larger
    buffer: its base is not 16-byte aligned."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _exact_inputs(B, H, Hkv, S, K, Dh, dtype, dev, seed=0, shift=None):
    """q from model layout (a strided kernel-layout view), k̄/v̄ (B, Hkv, K,
    Dh) views of (B, K, Hkv, Dh), as the model passes them; `shift` "q"
    moves q one element into its buffer."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, S, H, Dh, generator=g, device=dev).to(dtype)
    kb, vb = (torch.randn(B, K, Hkv, Dh, generator=g, device=dev).to(dtype)
              for _ in range(2))
    if shift == "q":
        q = _shifted(q)
    return q.movedim(2, 1), kb.movedim(2, 1), vb.movedim(2, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", list(EXACT_SHAPES))
def test_exact_kernel_matches_plain(cuda, dtype, shape):
    B, H, Hkv, S, K, Dh = EXACT_SHAPES[shape]
    args = _exact_inputs(B, H, Hkv, S, K, Dh, dtype, cuda,
                         shift=EXACT_SHIFTED.get(shape))
    n0 = la.linformer_attn.launches
    out = la.linformer_attn(*args, scale=Dh ** -0.5)
    torch.cuda.synchronize()
    assert la.linformer_attn.launches == n0 + 1
    ref = la.linformer_attn_plain(*args, scale=Dh ** -0.5)
    assert out.dtype == dtype and out.shape == ref.shape
    _assert_close(out, ref, (args[2],))


def _sp_inputs(B, H, S, K, Dh, rows, dtype, dev, seed=0, shift=None):
    """x a kernel-layout view of (B, S, H, Dh), E[:S] of a (rows, K) E;
    `shift` "x" or "E" moves that operand one element into its buffer."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(B, S, H, Dh, generator=g, device=dev).to(dtype)
    E = (torch.randn(rows, K, generator=g, device=dev) * K ** -0.5).to(dtype)
    if shift == "x":
        x = _shifted(x)
    if shift == "E":
        E = _shifted(E)
    return x.movedim(2, 1), E[:S]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", list(SP_SHAPES))
def test_seq_projection_kernel_matches_plain(cuda, dtype, shape):
    x, E = _sp_inputs(*SP_SHAPES[shape], dtype, cuda,
                      shift=SP_SHIFTED.get(shape))
    n0 = sp.seq_projection.launches
    out = sp.seq_projection(x, E)
    torch.cuda.synchronize()
    assert sp.seq_projection.launches == n0 + 1
    ref = sp.seq_projection_plain(x, E)
    assert out.dtype == dtype and out.shape == ref.shape
    _assert_grad_close(out, ref)
    # deterministic: no atomics, one summation order
    assert torch.equal(sp.seq_projection(x, E), out)


# the device kernel each dtype of kernels 5 and 6 runs: bf16 the tensor-core
# design, fp32 the SIMT one
DEVICE_KERNELS = {
    ("linformer_attn", torch.bfloat16): "exact_fwd_mma_kernel",
    ("linformer_attn", torch.float32): "exact_fwd_kernel",
    ("seq_projection", torch.bfloat16): "seq_projection_mma_kernel",
    ("seq_projection", torch.float32): "seq_projection_kernel",
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["linformer_attn", "seq_projection"])
def test_exact_kernels_run_their_dtypes_design(cuda, kernel, dtype):
    """Profile one launch at the paper's full width: a bf16 launch runs the
    tensor-core kernel and no SIMT one, an fp32 launch the SIMT kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    if kernel == "linformer_attn":
        B, H, Hkv, S, K, Dh = EXACT_SHAPES["full"]
        args = _exact_inputs(B, H, Hkv, S, K, Dh, dtype, cuda)
        fn = lambda: la.linformer_attn(*args, scale=Dh ** -0.5)  # noqa: E731
    else:
        x, E = _sp_inputs(*SP_SHAPES["full"], dtype, cuda)
        fn = lambda: sp.seq_projection(x, E)  # noqa: E731
    # the first step is a discarded warm-up: the profiler traces the second
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    names = [e.key for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA]
    want = DEVICE_KERNELS[kernel, dtype]
    other = DEVICE_KERNELS[kernel, ({torch.float32, torch.bfloat16}
                                    - {dtype}).pop()]
    assert [n for n in names if want in n], names
    assert not [n for n in names if other in n], names


@pytest.mark.parametrize("shape", ["ragged_gqa2", "full"])
def test_exact_functions_grads_match_autograd_through_plain(cuda, shape):
    """LinformerAttnFn and SeqProjectionFn (kernels 5 and 6 forward, the
    analytic backwards) against autograd through the plain twins, fp32,
    chained as the model chains them: k̄ = Eᵀk, v̄ = Fᵀv, then attention."""
    B, H, Hkv, S, K, Dh = EXACT_SHAPES[shape]
    g = torch.Generator(device=cuda).manual_seed(7)
    xs = [torch.randn(*sh, generator=g, device=cuda).requires_grad_()
          for sh in ((B, S, H, Dh), (B, S, Hkv, Dh), (B, S, Hkv, Dh),
                     (S, K), (S, K))]
    do = torch.randn(B, S, H, Dh, generator=g, device=cuda)
    sc = Dh ** -0.5
    tk = lambda t: t.movedim(2, 1)  # noqa: E731  model <-> kernel layout

    def through_kernels(q, k, v, E, F):
        kb, vb = tops.fused_seq_projection(k, E), tops.fused_seq_projection(
            v, F)
        return tops.fused_linformer_attention(q, kb, vb, scale=sc)

    def through_plain(q, k, v, E, F):
        kb, vb = sp.seq_projection_plain(tk(k), E), sp.seq_projection_plain(
            tk(v), F)
        return tk(la.linformer_attn_plain(tk(q), kb, vb, scale=sc))

    n5, n6 = la.linformer_attn.launches, sp.seq_projection.launches
    got = torch.autograd.grad(through_kernels(*xs), xs, do)
    assert la.linformer_attn.launches == n5 + 1
    assert sp.seq_projection.launches == n6 + 2
    want = torch.autograd.grad(through_plain(*xs), xs, do)
    for a, b_ in zip(got, want):
        _assert_grad_close(a, b_)


def test_smoke_encoder_train_step_through_kernels_matches_reference(cuda):
    """linformer-paper SMOKE in fp32 on the card: loss and every gradient
    leaf through kernels 5 and 6 against the plain reference route."""
    from repro_torch.data.pipeline import (DataState, SyntheticCorpus,
                                           make_mlm_batch)
    cfg = dataclasses.replace(get_smoke_config("linformer-paper"),
                              dtype="float32")
    batch = make_mlm_batch(SyntheticCorpus(cfg.vocab_size, seed=0),
                           DataState(0, 0), batch=2, seq=96)
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in batch.items()}
    res = {}
    for backend in ("auto", "reference"):
        c = cfg.with_attention_backend(backend)
        params = tmodel.init_params(c, seed=0, device=cuda)
        leaves = flatten(params)
        for p in leaves.values():
            p.requires_grad_(True)
        n5 = la.linformer_attn.launches
        loss, _ = tmodel.loss_fn(params, c, batch)
        res[backend] = loss.item(), torch.autograd.grad(
            loss, list(leaves.values()))
        assert (la.linformer_attn.launches > n5) == (backend == "auto")
    assert abs(res["auto"][0] - res["reference"][0]) <= \
        1e-5 * abs(res["reference"][0])
    for a, b_ in zip(res["auto"][1], res["reference"][1]):
        _assert_grad_close(a, b_)


# the nonuniform path's per-layer K (linformer-paper, k = 128, k_decay 0.5,
# 12 layers): kernels 5 and 6 at the paper's full width, B=32, H=12,
# S=512, Dh=64; only 128 and 64 are multiples of the MMA tiles
NONUNIFORM_K = tuple(effective_k(128, 0.5, i, 12) for i in range(12))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", NONUNIFORM_K)
def test_exact_kernels_at_the_nonuniform_k(cuda, K, dtype):
    B, H, S, Dh = 32, 12, 512, 64
    args = _exact_inputs(B, H, H, S, K, Dh, dtype, cuda, seed=K)
    out = la.linformer_attn(*args, scale=Dh ** -0.5)
    torch.cuda.synchronize()
    _assert_close(out, la.linformer_attn_plain(*args, scale=Dh ** -0.5),
                  (args[2],))
    x, E = _sp_inputs(B, H, S, K, Dh, 512, dtype, cuda, seed=K)
    out = sp.seq_projection(x, E)
    torch.cuda.synchronize()
    assert out.shape == (B, H, K, Dh)
    _assert_grad_close(out, sp.seq_projection_plain(x, E))


def test_full_width_standard_decode_step_matches_the_cpu(cuda):
    """qwen3-8b at full width (cut to 2 layers), kind "standard", fp32: a
    64-token prefill into the full cache and one decode step on the card
    give the CPU's logits within 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import nest
    cfg = dataclasses.replace(get_config("qwen3-8b"), num_layers=2,
                              dtype="float32").with_attention_kind("standard")
    params = tmodel.init_params(cfg, seed=0, device="cpu")
    toks = torch.randint(4, cfg.vocab_size, (2, 65),
                         generator=torch.Generator().manual_seed(0))
    got = []
    for dev in ("cpu", cuda):
        p = params if dev == "cpu" else nest(
            {k: v.to(dev) for k, v in flatten(params).items()})
        with torch.no_grad():
            lg, _, cache = tmodel.forward(
                p, cfg, {"tokens": toks[:, :64].to(dev)}, return_cache=True,
                cache_max_seq=128, cache_dtype=torch.float32)
            step, cache = tmodel.decode_step(p, cfg, toks[:, 64:].to(dev),
                                             cache)
        assert cache["lengths"].tolist() == [65, 65]
        got.append((lg[:, -1].cpu(), step[:, 0].cpu(), cache["k"].cpu()))
    for a, b in zip(*got):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)


# -- SLO serving on the card: row surgery, snapshots, the NaN guard, sampling

SURGERY_POOLS = {"dense-fp32": dict(cache_dtype=torch.float32),
                 "dense-bf16": dict(cache_dtype=torch.bfloat16),
                 "paged-int8": dict(cache_format="paged"),
                 "paged-fp8": dict(cache_format="paged", page_dtype="fp8")}


def _slo_engine(dev, pool, **kw):
    cfg = dataclasses.replace(get_smoke_config("qwen3-8b"), dtype="float32")
    params = tmodel.init_params(cfg, seed=0, device=dev)
    opts = {"cache_dtype": torch.float32, **SURGERY_POOLS[pool], **kw}
    return ServingEngine(params, cfg, max_seq=96, device=dev,
                         decode_chunk=4, **opts)


def _random_pool(eng, max_batch, seed=0):
    """Every leaf of a CPU pool filled from a seeded generator: finite fp8
    codes up to the largest (whose garble overflows), int8 codes, small
    positive scales, page ids, lengths."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in eng.init_pool_cache(max_batch).items():
        if k == "lengths":
            out[k] = torch.randint(0, 40, v.shape, generator=g,
                                   dtype=torch.int32)
        elif k == "page_table":
            out[k] = torch.randint(-1, 8, v.shape, generator=g,
                                   dtype=torch.int32)
        elif v.dtype == torch.int8:
            out[k] = torch.randint(-128, 128, v.shape, generator=g,
                                   dtype=torch.int8)
        elif v.element_size() == 1:
            codes = torch.randint(0, 0x7F, v.shape, generator=g,
                                  dtype=torch.uint8)
            sign = torch.randint(0, 2, v.shape, generator=g,
                                 dtype=torch.uint8) << 7
            out[k] = (codes | sign).view(v.dtype)
        else:
            x = torch.randn(v.shape, generator=g) * 3
            out[k] = (x.abs() / 100 if k.endswith("_s") else x).to(v.dtype)
    return out


def _bytes(t):
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)


@pytest.mark.parametrize("op", ["garble", "nan", "scrub"])
@pytest.mark.parametrize("pool", list(SURGERY_POOLS))
def test_row_surgery_on_the_card_matches_the_cpu(cuda, pool, op):
    """corrupt_pool_row(_paged) and scrub_pool_row on a CUDA pool give the
    CPU's bytes (which tests/test_torch_faults.py holds to JAX's), fp8
    overflow to NaN included; a scrubbed row reads exact zeros."""
    ecpu, ecuda = _slo_engine("cpu", pool), _slo_engine(cuda, pool)
    cpu = _random_pool(ecpu, 3)
    dev = {k: v.to(cuda) for k, v in cpu.items()}
    row, pages = 1, [4, 0, 6]
    for eng, p in ((ecpu, cpu), (ecuda, dev)):
        if op == "scrub":
            eng.scrub_pool_row(p, row)
        elif eng.paged:
            eng.corrupt_pool_row_paged(p, row, pages, op)
        else:
            eng.corrupt_pool_row(p, row, op)
    torch.cuda.synchronize()
    for k in cpu:
        assert torch.equal(_bytes(dev[k]), _bytes(cpu[k])), k
    if op == "scrub":
        keys = ("raw_k_q", "raw_v_q", "raw_k_s", "raw_v_s") \
            if ecuda.paged else [k for k in dev if k != "lengths"]
        for k in keys:
            assert (_bytes(dev[k][:, row]) == 0).all(), k
        assert dev["lengths"][row].item() == 0


@pytest.mark.parametrize("pool", list(SURGERY_POOLS))
def test_snapshot_round_trip_on_the_card(cuda, pool):
    """A row snapshotted from a CUDA pool holds the CPU snapshot's bytes
    (same checksum) and, restored into another row (a paged one into other
    pages), reads back byte-identical."""
    from repro_torch.serving.snapshot import capture
    ecpu, ecuda = _slo_engine("cpu", pool), _slo_engine(cuda, pool)
    cpu = _random_pool(ecpu, 3)
    if ecuda.paged:                     # row 0 owns pages 2 and 5
        cpu["page_table"][:] = -1
        cpu["page_table"][:, 0, :2] = torch.tensor([2, 5], dtype=torch.int32)
        cpu["lengths"][0] = 2 * 16 + 7
    dev = {k: v.to(cuda) for k, v in cpu.items()}
    snaps = [capture(rid=0, state="decoding", filled=1, cur=0,
                     finished=False, emitted=[],
                     cache_rows=eng.snapshot_pool_rows(p, [0])[0], tick=0)
             for eng, p in ((ecpu, cpu), (ecuda, dev))]
    assert snaps[0].checksum == snaps[1].checksum and snaps[1].verify()
    if ecuda.paged:
        ecuda.restore_pool_rows_paged(dev, snaps[1].cache_rows, 2, [7, 1])
        for k in ("raw_k_q", "raw_v_q", "raw_k_s", "raw_v_s"):
            assert torch.equal(_bytes(dev[k][:, 2]), _bytes(cpu[k][:, 0])), k
        for k in ("page_k", "page_v", "page_k_s", "page_v_s"):
            assert torch.equal(_bytes(dev[k][:, [7, 1]]),
                               _bytes(cpu[k][:, [2, 5]])), k
        assert dev["page_table"][0, 2, :3].tolist() == [7, 1, -1]
    else:
        ecuda.restore_pool_rows(dev, snaps[1].cache_rows, 2)
        for k in cpu:
            a = dev[k][2] if k == "lengths" else dev[k][:, 2]
            b = cpu[k][0] if k == "lengths" else cpu[k][:, 0]
            assert torch.equal(_bytes(a), _bytes(b)), k
    assert dev["lengths"][2].item() == cpu["lengths"][0].item()


@pytest.mark.parametrize("pool", ["dense-fp32", "paged-int8"])
def test_nan_row_flagged_through_the_decode_kernels(cuda, pool):
    """A NaN-poisoned row's live keys (dense) or scales (paged) make its
    logits non-finite through kernel 3 / kernel 7: the guard quarantines
    exactly that row (the kernels read no masked key, so no neighbour is
    flagged) and the serve ends with the fault-free tokens."""
    from repro_torch.serving import Fault, FaultInjector
    eng = _slo_engine(cuda, pool, prefill_chunk=32)
    kernel = la.decode_attn_q if eng.paged else la.decode_attn
    prompts = [[5 + i] * n for i, n in enumerate([8, 19, 35, 48, 70])]
    clean = eng.serve(prompts, 12, max_batch=3)
    n0 = kernel.launches
    out, sched = eng.serve(
        prompts, 12, max_batch=3,
        fault_injector=FaultInjector([Fault("nan_logits", chunk=1, row=0)]),
        return_scheduler=True)
    assert kernel.launches > n0
    assert sched.stats.quarantines == 1 and sched.stats.retries == 1
    assert out == clean


def test_sampling_with_a_cuda_generator(cuda):
    """Gumbel-max on the card: one CUDA generator seed gives one draw, a
    CPU generator is refused by the engine, and 20000 draws from one
    logits row sit within 0.02 total variation of softmax(logits / T) over
    10 equal-mass bins."""
    T = 0.8
    g = torch.Generator(device="cpu").manual_seed(0)
    logits = (torch.randn(1, 512, generator=g) * 2).to(cuda)
    draw = lambda seed, n: tmodel.sample(  # noqa: E731
        logits.expand(n, -1), T,
        torch.Generator(device=cuda).manual_seed(seed))
    assert torch.equal(draw(1, 64), draw(1, 64))
    assert not torch.equal(draw(1, 64), draw(2, 64))
    probs = torch.softmax(logits[0].double() / T, -1).cpu()
    order = torch.argsort(probs, descending=True)
    cum = torch.cumsum(probs[order], 0)
    bin_of = torch.empty(512, dtype=torch.long)
    bin_of[order] = torch.clamp((cum - probs[order] / 2) * 10, max=9).long()
    n = 20000
    got = torch.bincount(bin_of[draw(3, n).cpu()], minlength=10).double() / n
    want = torch.zeros(10, dtype=torch.double).index_add_(0, bin_of, probs)
    assert 0.5 * (got - want).abs().sum().item() <= 0.02
    eng = _slo_engine(cuda, "dense-fp32", temperature=T)
    with pytest.raises(ValueError, match="engine's device"):
        eng.serve([[5] * 9], 4, generator=torch.Generator())
    outs = [eng.serve([[5] * 9, [6] * 20], 8, max_batch=2,
                      generator=torch.Generator(device=cuda).manual_seed(4))
            for _ in range(2)]
    assert outs[0] == outs[1]


@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_apply_moe_on_cuda_matches_cpu_and_is_deterministic(cuda, cf):
    """qwen3-moe's routing (128 experts, top 8) at d = 256 over 3 × 40
    tokens, capacity dropping: fp32 routes and drops equal to the CPU's,
    outputs within 1e-5; bf16 (the router fp32) bit-identical across two
    calls."""
    D, E, ff = 256, 128, 64
    cfg = MoEConfig(num_experts=E, top_k=8, expert_d_ff=ff,
                    capacity_factor=cf)
    mlp = MLPConfig(d_ff=ff)
    g = torch.Generator().manual_seed(0)
    params = {"router": torch.randn(D, E, generator=g) * D ** -0.5,
              "w_in": torch.randn(E, D, ff, generator=g) * D ** -0.5,
              "w_gate": torch.randn(E, D, ff, generator=g) * D ** -0.5,
              "w_out": torch.randn(E, ff, D, generator=g) * ff ** -0.5}
    x = torch.randn(3, 40, D, generator=g)
    out_c, aux_c = tmoe.apply_moe(params, x, cfg, mlp)
    gp = {k: v.to(cuda) for k, v in params.items()}
    out_g, aux_g = tmoe.apply_moe(gp, x.to(cuda), cfg, mlp)
    r_c = tmoe.route(params["router"], x.reshape(-1, D), cfg)
    r_g = tmoe.route(gp["router"], x.to(cuda).reshape(-1, D), cfg)
    assert torch.equal(r_c["top_i"], r_g["top_i"].cpu())
    assert torch.equal(r_c["keep"], r_g["keep"].cpu())
    assert not r_g["keep"].all()
    assert (out_g.cpu() - out_c).abs().max().item() <= 1e-5
    assert abs(aux_g.item() - aux_c.item()) <= 1e-5
    bf = {k: v if k == "router" else v.to(torch.bfloat16)
          for k, v in gp.items()}
    xb = x.to(cuda, torch.bfloat16)
    a, aux_a = tmoe.apply_moe(bf, xb, cfg, mlp)
    b, aux_b = tmoe.apply_moe(bf, xb, cfg, mlp)
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    assert torch.equal(aux_a, aux_b)


# -- the ssm and hybrid families ---------------------------------------------

# full width; zamba2 cut to 7 layers (one shared-block invocation and a
# trailing trunk layer), rwkv6 to 2; the prefill a whole Linformer block
SSM_CUTS = {"zamba2-1.2b": (7, 256), "rwkv6-1.6b": (2, 64)}


@pytest.mark.parametrize("arch", list(SSM_CUTS))
def test_ssm_and_hybrid_decode_step_matches_the_cpu(cuda, arch):
    """fp32 at full width: a prefill and one decode step on the card give
    the CPU's logits within 1e-4 and its cache leaves within 1e-4 (plus
    1e-4 relative: the summed recurrent states grow past 1)."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import nest
    layers, S = SSM_CUTS[arch]
    cfg = dataclasses.replace(get_config(arch), num_layers=layers,
                              dtype="float32")
    params = tmodel.init_params(cfg, seed=0, device="cpu")
    toks = torch.randint(4, cfg.vocab_size, (2, S + 1),
                         generator=torch.Generator().manual_seed(0))
    got = []
    for dev in ("cpu", cuda):
        p = params if dev == "cpu" else nest(
            {k: v.to(dev) for k, v in flatten(params).items()})
        with torch.no_grad():
            lg, _, cache = tmodel.forward(
                p, cfg, {"tokens": toks[:, :S].to(dev)}, return_cache=True,
                cache_max_seq=512, cache_dtype=torch.float32)
            step, cache = tmodel.decode_step(p, cfg, toks[:, S:].to(dev),
                                             cache)
        assert int(cache["length"]) == S + 1
        got.append((lg[:, -1].cpu(), step[:, 0].cpu(),
                    {k: v.cpu() for k, v in flatten(cache).items()}))
    for a, b in zip(got[0][:2], got[1][:2]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
    for k, v in got[0][2].items():
        torch.testing.assert_close(got[1][2][k], v, rtol=1e-4, atol=1e-4,
                                   msg=k)


def test_rwkv6_chunked_form_finite_at_chunk_128_and_4096_tokens(cuda):
    """rwkv6-1.6b at full width (chunk 128), 1 layer, fp32, 4096 tokens:
    JAX's single-chunk factorisation overflows there; the port's capped
    chunks keep every logit finite and its last 8 positions within 2e-3
    of the decode_step loop over the same tokens."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("rwkv6-1.6b"), num_layers=1,
                              dtype="float32")
    assert cfg.rwkv.chunk_size == 128
    params = tmodel.init_params(cfg, seed=0, device=cuda)
    toks = torch.randint(4, cfg.vocab_size, (1, 4096), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(0))
    with torch.no_grad():
        full = tmodel.forward(params, cfg, {"tokens": toks})[0]
        cache = tmodel.init_cache(cfg, batch=1, max_seq=4096,
                                  dtype=torch.float32, device=cuda)
        for t in range(4096):
            step, cache = tmodel.decode_step(params, cfg, toks[:, t:t + 1],
                                             cache)
            if t >= 4088:
                torch.testing.assert_close(step[:, 0], full[:, t], rtol=0,
                                           atol=2e-3)
    assert torch.isfinite(full).all()


def test_zamba2_kernel_counters_on_prefill_and_decode_step(cuda):
    """zamba2 SMOKE (two shared-block invocations) in fp32 on the card: a
    prefill forward launches kernel 1 once per invocation and nothing
    else, a decode step kernel 3 once per invocation; the logits match the
    reference route's within 1e-4."""
    cfg = dataclasses.replace(get_smoke_config("zamba2-1.2b"),
                              dtype="float32")
    params = tmodel.init_params(cfg, seed=0, device=cuda)
    toks = torch.randint(4, cfg.vocab_size, (2, 33), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(0))
    n_inv = cfg.num_layers // cfg.hybrid_attn_every
    got = {}
    for backend in ("auto", "reference"):
        c = cfg.with_attention_backend(backend)
        bca.blockwise_causal_attn.launches = 0
        la.decode_attn.launches = 0
        with torch.no_grad():
            lg, _, cache = tmodel.forward(
                params, c, {"tokens": toks[:, :32]}, return_cache=True,
                cache_max_seq=64, cache_dtype=torch.float32)
            prefill = bca.blockwise_causal_attn.launches
            step, _ = tmodel.decode_step(params, c, toks[:, 32:], cache)
        counts = (prefill, la.decode_attn.launches)
        assert counts == ((n_inv, n_inv) if backend == "auto" else (0, 0))
        got[backend] = (lg, step)
    for a, b in zip(got["auto"], got["reference"]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)


@pytest.mark.parametrize("mode", ["monolithic", "paged-int8"])
def test_telemetry_changes_no_token_and_no_launch(cuda, mode):
    """qwen3-8b SMOKE in fp32 on the card, served with a `Telemetry` and
    without, under priorities, a bounded queue and a preemption: the same
    tokens, ShedResults, scheduler counters and launches of each kernel;
    the traced run holds its serve and decode_chunk spans."""
    from repro_torch.telemetry import Telemetry
    cfg = dataclasses.replace(get_smoke_config("qwen3-8b"), dtype="float32")
    params = tmodel.init_params(cfg, seed=0, device=cuda)
    prompts = [[5 + i] * n for i, n in enumerate([8, 19, 35, 48, 70, 16])]
    kw = dict(prefill_chunk=32, cache_format="paged") \
        if mode != "monolithic" else {}
    counters = [(bca.blockwise_causal_attn, "launches"),
                (bca.blockwise_causal_prefix_attn_q, "launches"),
                (la.decode_attn, "launches"), (la.decode_attn_q, "launches")]
    eng = ServingEngine(params, cfg, max_seq=96, device=cuda,
                        cache_dtype=torch.float32, decode_chunk=4, **kw)
    runs = []
    for tel in (None, Telemetry()):
        n0 = [getattr(f, a) for f, a in counters]
        outs, sched = eng.serve(
            prompts, 12, max_batch=3, priorities=[2, 2, 2, 1, 0, 0],
            arrival_chunks=[0, 0, 0, 1, 2, 2], max_queue=4,
            return_scheduler=True, telemetry=tel)
        torch.cuda.synchronize()
        runs.append((outs, sched.stats.counter_records(),
                     [getattr(f, a) - n for (f, a), n in zip(counters, n0)],
                     sched.completed_at))
    assert runs[0] == runs[1]
    assert sched.stats.preemptions > 0
    assert sum(runs[1][2]) > 0
    spans = {e["name"] for e in tel.tracer.chrome_events() if e["ph"] == "X"}
    assert {"serve", "decode_chunk"} <= spans
