"""The exact form's shared-memory mirrors and shape guards
(``repro_torch/kernels/common.py``) against the CUDA sources they mirror.

The guards run on the CPU before any launch, so the bytes they compute must
be the bytes ``csrc/linformer_attn.cu`` (kernel 5) and
``csrc/seq_projection.cu`` (kernel 6) ask for: the tile constants are read
from the sources here and the layout their comments state (fp32 SIMT
tiles; bf16 tensor-core tiles of pitch Dh + 8) is rebuilt from them."""
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import common

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
DTYPES = [torch.float32, torch.bfloat16]
PAPER = dict(heads=12, kv_heads=12, slots=128, head_dim=64)
K512_DH128 = dict(heads=4, kv_heads=4, slots=512, head_dim=128)


def _tc_constants(source: str) -> dict:
    """`constexpr int kName = <integer expression>;` lines of the
    tensor-core section (namespace tc) of one source that do not depend on
    the head dim, evaluated in order."""
    text = (CSRC / source).read_text()
    body = text[text.index("namespace tc {"):]
    env: dict = {}
    for name, expr in re.findall(r"constexpr int (k\w+) = ([^;]+);", body):
        if re.fullmatch(r"[\w\s*+]+", expr) and "Dh" not in expr \
                and all(w.isdigit() or w in env
                        for w in re.findall(r"\w+", expr)):
            env[name] = eval(expr, {}, dict(env))
    return env


def _ternary(source: str, name: str):
    """`kName = Dh <= 64 ? a : b` of a source, as a function of Dh."""
    text = (CSRC / source).read_text()
    m = re.search(rf"{name} = Dh <= (\d+) \? (\d+) : (\d+);", text)
    assert m, f"{name} not found in {source}"
    lim, a, b = map(int, m.groups())
    return lambda dh: a if dh <= lim else b


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", ["paper", "k512_dh128"])
def test_exact_guards_take_the_paper_shape_and_k512(dtype, shape):
    kw = PAPER if shape == "paper" else K512_DH128
    common.check_exact_shapes(dtype=dtype, **kw)
    assert common.exact_smem_bytes(kw["head_dim"], dtype, kw["slots"]) \
        <= common.MAX_SMEM_PER_BLOCK


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seq,slots,head_dim",
                         [(512, 128, 64), (512, 512, 128), (77, 70, 128),
                          (40, 1, 16)])
def test_seq_projection_guards_take_the_paper_shape_and_k512(
        dtype, seq, slots, head_dim):
    common.check_seq_projection_shapes(seq=seq, rows=seq, slots=slots,
                                       head_dim=head_dim, dtype=dtype)


@pytest.mark.parametrize("head_dim", common.EXACT_HEAD_DIMS)
@pytest.mark.parametrize("slots", [1, 40, 128, 130, 512])
def test_exact_bf16_mirror_is_the_kernel_layout(head_dim, slots):
    tc = _tc_constants("linformer_attn.cu")
    tile_kv = _ternary("linformer_attn.cu", "kTileKV")(head_dim)
    assert tc["kTileQ"] == 16 * tc["kWarps"] == common.EXACT_MMA_TILE_Q
    assert tc["kQTiles"] == common.EXACT_MMA_Q_TILES
    assert tile_kv == common.exact_mma_tile_kv(head_dim)
    # bf16 rows of pitch Dh + 8: two q tiles, then k̄ and v̄ tiles per stage
    stages = 1 if slots <= tile_kv else 2
    want = 2 * (head_dim + 8) * (tc["kQTiles"] * tc["kTileQ"]
                                 + stages * 2 * tile_kv)
    assert common.exact_smem_bytes(head_dim, torch.bfloat16, slots) == want
    # shared memory does not grow with K past two stages
    assert common.exact_smem_bytes(head_dim, torch.bfloat16, 512) == \
        common.exact_smem_bytes(head_dim, torch.bfloat16, tile_kv + 1)


def test_exact_mirrors_at_the_paper_shape():
    # bf16: 2 x 64 q rows + 128 k̄ + 128 v̄ slots, one stage, 72-element
    # rows: 54 KB, four blocks an SM
    assert common.exact_smem_bytes(64, torch.bfloat16, 128) == \
        2 * 72 * (128 + 256) == 55296
    # K = 512 at Dh = 128: 64-slot tiles in two stages, 136-element rows
    assert common.exact_smem_bytes(128, torch.bfloat16, 512) == \
        2 * 136 * (128 + 2 * 128) == 104448
    # fp32 (SIMT, unchanged): 70.4 KB at Dh = 64, 119.5 KB at Dh = 128
    assert common.exact_smem_bytes(64, torch.float32, 128) == 70400
    assert common.exact_smem_bytes(128, torch.float32, 512) == 119552


@pytest.mark.parametrize("head_dim", common.SP_HEAD_DIMS)
def test_seq_projection_bf16_mirror_is_the_kernel_layout(head_dim):
    tc = _tc_constants("seq_projection.cu")
    assert tc["kTileK"] == tc["kWarps"] * tc["kWarpSlots"] \
        == common.SP_MMA_TILE_K
    assert tc["kChunkS"] == common.SP_MMA_CHUNK_S
    assert tc["kStages"] == common.SP_MMA_STAGES
    assert tc["kEPitch"] == tc["kTileK"] + 8
    # per stage: a chunk of x (pitch Dh + 8) and of E (pitch tile + 8)
    want = 2 * tc["kStages"] * tc["kChunkS"] * (head_dim + 8 + tc["kEPitch"])
    assert common.seq_projection_smem_bytes(head_dim, torch.bfloat16) == want
    # fp32 (SIMT, unchanged): a 32-row step of E and x in fp32
    assert common.seq_projection_smem_bytes(head_dim, torch.float32) == \
        4 * 32 * (64 + head_dim)


def test_seq_projection_mirror_at_the_paper_shape():
    # bf16, Dh = 64: two stages of 64 rows of x (72) and of E (136): 52 KB,
    # four blocks an SM by shared memory
    assert common.seq_projection_smem_bytes(64, torch.bfloat16) == \
        2 * 2 * 64 * (72 + 136) == 53248
    # fp32 (SIMT, unchanged): 16 KB
    assert common.seq_projection_smem_bytes(64, torch.float32) == 16384


@pytest.mark.parametrize("dtype", DTYPES)
def test_exact_guards_refuse_what_the_kernels_do_not_take(dtype):
    with pytest.raises(ValueError, match="head dims"):
        common.check_exact_shapes(heads=4, kv_heads=4, slots=8, head_dim=48,
                                  dtype=dtype)
    with pytest.raises(ValueError, match="512"):
        common.check_exact_shapes(heads=4, kv_heads=4, slots=513,
                                  head_dim=64, dtype=dtype)
    with pytest.raises(ValueError, match="multiple"):
        common.check_exact_shapes(heads=6, kv_heads=4, slots=8, head_dim=64,
                                  dtype=dtype)
    with pytest.raises(ValueError, match="E\\[:S\\]"):
        common.check_seq_projection_shapes(seq=64, rows=128, slots=8,
                                           head_dim=64, dtype=dtype)


def test_mirrors_refuse_other_dtypes():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        common.exact_smem_bytes(64, torch.float16, 128)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        common.seq_projection_smem_bytes(64, torch.float16)
