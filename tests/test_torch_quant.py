"""Port parity: blockwise int8 quantization and the int8 KV-pool writes.

``unionml_tpu_torch.ops.quant.quantize_blockwise`` and the pool writes
``_paged_append_quantized`` / ``_paged_chunk_quantized`` of
``unionml_tpu_torch.models.gpt`` against their JAX originals on the same
float32 inputs (made with numpy from a seed). Tolerance: none — int8 codes
and float32 scales must be BITWISE equal (the arithmetic is the same float32
ops in the same order, with round half to even on both sides). Cases cover
fresh blocks, monotone scale growth, a shrinking token (scale kept, codes
untouched), all-zero blocks (scale 0) and chunks that straddle blocks or run
past the table into the scratch column.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unionml_tpu.models import gpt as jgpt
from unionml_tpu.ops import quant as jquant
from unionml_tpu_torch.models import gpt as tgpt
from unionml_tpu_torch.ops import quant as tquant

HEADS, HD, BS = 2, 8, 4


def _same(jax_array, torch_tensor) -> bool:
    a = np.asarray(jax_array)
    b = torch_tensor.numpy()
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("zero_blocks", [0, 1, 3])
@pytest.mark.parametrize("reduce_axes", [(3, 4), (4,), (0, 2)])
def test_quantize_blockwise_bitwise(reduce_axes, zero_blocks):
    rng = np.random.default_rng(len(reduce_axes) * 7 + zero_blocks)
    x = rng.normal(size=(3, 4, 2, BS, HD)).astype(np.float32) * rng.uniform(0.01, 10.0)
    x[:zero_blocks] = 0.0  # all-zero blocks store scale 0
    jq, js = jquant.quantize_blockwise(jnp.asarray(x), reduce_axes)
    tq, ts = tquant.quantize_blockwise(torch.from_numpy(x), reduce_axes)
    assert _same(jq, tq) and _same(js, ts)
    back = tquant.dequantize_blockwise(tq, ts)
    assert np.array_equal(np.asarray(jquant.dequantize_blockwise(jq, js)), back.numpy())


def _pool(blocks: int, seed: int):
    rng = np.random.default_rng(seed)
    codes = rng.integers(-127, 128, (blocks, HEADS, BS, HD)).astype(np.int8)
    scales = rng.uniform(0.001, 0.05, (blocks, HEADS, 1, 1)).astype(np.float32)
    return codes, scales


# per step: (offsets of the 3 rows, magnitude of the appended token)
APPEND_SCHEDULES = {
    "fresh": [((0, 0, 0), 1.0)],
    "growth": [((0, 0, 0), 0.5), ((1, 1, 1), 3.0), ((2, 2, 2), 7.0)],
    "shrink": [((0, 0, 0), 5.0), ((1, 1, 1), 0.1), ((2, 2, 2), 0.2)],
    "zeros": [((0, 0, 0), 0.0), ((1, 1, 1), 0.0), ((2, 2, 2), 2.0)],
    "mixed": [((0, 2, 3), 1.0), ((1, 3, 0), 4.0), ((2, 0, 1), 0.0)],
}


@pytest.mark.parametrize("schedule", sorted(APPEND_SCHEDULES))
def test_paged_append_quantized_bitwise(schedule):
    codes, scales = _pool(5, seed=len(schedule))
    rng = np.random.default_rng(11)
    jq, js = jnp.asarray(codes), jnp.asarray(scales)
    tq, ts = torch.from_numpy(codes.copy()), torch.from_numpy(scales.copy())
    dst = np.asarray([1, 3, 4], dtype=np.int32)  # distinct blocks per row
    for offsets, magnitude in APPEND_SCHEDULES[schedule]:
        vals = (rng.normal(size=(3, HEADS, HD)) * magnitude).astype(np.float32)
        off = np.asarray(offsets, dtype=np.int32)
        jq, js = jgpt._paged_append_quantized(jq, js, jnp.asarray(dst), jnp.asarray(off), jnp.asarray(vals))
        tgpt._paged_append_quantized(tq, ts, torch.from_numpy(dst), torch.from_numpy(off), torch.from_numpy(vals))
        assert _same(jq, tq) and _same(js, ts)


# (position, chunk length, table width, magnitude)
CHUNK_CASES = [
    (0, 8, 4, 1.0),  # block-aligned, fresh blocks
    (3, 6, 4, 2.0),  # starts mid-block: the first block's old scale carries over
    (5, 12, 6, 0.5),  # straddles four blocks
    (2, 4, 4, 0.0),  # all-zero chunk into a block with live content
    (9, 8, 4, 3.0),  # runs past the table: logical blocks clamp to the scratch column
]


@pytest.mark.parametrize("position,seq,width,magnitude", CHUNK_CASES)
def test_paged_chunk_quantized_bitwise(position, seq, width, magnitude):
    codes, scales = _pool(8, seed=position * 31 + seq)
    rng = np.random.default_rng(position + 100 * seq)
    table_row = np.asarray([6, 2, 5, 0, 3, 1][: width - 1] + [7], dtype=np.int32)  # 7 = scratch
    vals = (rng.normal(size=(HEADS, seq, HD)) * magnitude).astype(np.float32)
    jq, js = jgpt._paged_chunk_quantized(
        jnp.asarray(codes), jnp.asarray(scales), jnp.asarray(table_row), position, jnp.asarray(vals)
    )
    tq, ts = tgpt._paged_chunk_quantized(
        torch.from_numpy(codes.copy()), torch.from_numpy(scales.copy()), torch.from_numpy(table_row),
        position, torch.from_numpy(vals),
    )
    # the scratch block may take several clamped writes (any one wins): compare live blocks
    live = table_row[:-1]
    assert _same(np.asarray(jq)[live], tq[live]) and _same(np.asarray(js)[live], ts[live])
    untouched = np.setdiff1d(np.arange(8), table_row)
    assert _same(codes[untouched], tq[untouched])


def test_kv_int8_budgets_match():
    assert tquant.KV_INT8_LOGPROB_DELTA_BUDGET == jquant.KV_INT8_LOGPROB_DELTA_BUDGET
    assert tquant.KV_INT8_GREEDY_DIVERGENCE_BUDGET == jquant.KV_INT8_GREEDY_DIVERGENCE_BUDGET
