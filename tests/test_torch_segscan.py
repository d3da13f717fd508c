"""Kernel B of the port (`eskf_lio_torch/ops/segscan.py`) vs the JAX
package's `segsum_sorted`, on the cases of `tests/test_segscan.py`.

Head rows only (the contract).  On CPU tensors the port runs its plain
version (`index_add_` totals); the JAX side runs its Pallas kernel in
interpret mode with 64-row blocks, as its own tests do.  Tolerance rtol /
atol 1e-5: both sum the same f32 values in different orders, O(1) values
over runs of at most a few hundred rows.  The CUDA kernel itself is held
against the plain version on the card in `test_torch_cuda.py`.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eskf_lio_torch.ops import segscan as t_seg
from eskf_lio_tpu.ops import segscan as j_seg

torch.set_num_threads(2)


def _heads(keys):
    return np.concatenate([[True], keys[1:] != keys[:-1]])


def _keys_vals(seed, n, n_keys, w=10):
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, n_keys, size=n).astype(np.int32))
    vals = rng.normal(size=(n, w)).astype(np.float32)
    return keys, vals


def _jax_heads(keys, vals, block=64):
    out = np.asarray(
        j_seg.segsum_sorted(jnp.asarray(keys), jnp.asarray(vals), interpret=True, block=block)
    )
    return out[_heads(keys)]


def _port_heads(keys, vals, device="cpu"):
    out = t_seg.segsum_sorted(
        torch.as_tensor(keys, device=device), torch.as_tensor(vals, device=device)
    )
    return out.cpu().numpy()[_heads(keys)]


CASES = {
    "within_block": (256, 64),
    "crossing_blocks": (512, 5),
    "non_multiple_size": (200, 30),
    "one_segment": (256, 1),
    "all_unique": (256, None),
}


def _case(name, seed=0):
    n, n_keys = CASES[name]
    if n_keys is None:
        rng = np.random.default_rng(seed)
        return np.arange(n, dtype=np.int32), rng.normal(size=(n, 4)).astype(np.float32)
    return _keys_vals(seed, n, n_keys)


@pytest.mark.parametrize("name", sorted(CASES))
def test_head_rows_match_jax(name):
    keys, vals = _case(name)
    np.testing.assert_allclose(
        _port_heads(keys, vals), _jax_heads(keys, vals), rtol=1e-5, atol=1e-5
    )


def test_plain_version_fills_every_row_with_its_total():
    keys, vals = _keys_vals(1, 300, 40)
    out = t_seg.segsum_sorted_ref(torch.as_tensor(keys), torch.as_tensor(vals)).numpy()
    for k in np.unique(keys):
        rows = keys == k
        np.testing.assert_allclose(out[rows], np.broadcast_to(vals[rows].sum(0), out[rows].shape),
                                   rtol=1e-5, atol=1e-5)


def test_wrapper_rejects_mixed_devices():
    keys, vals = _keys_vals(2, 64, 8)
    with pytest.raises(ValueError):
        t_seg.segsum_sorted(torch.as_tensor(keys), torch.as_tensor(vals, device="meta"))
