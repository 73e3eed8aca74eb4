"""Port parity: the routing helpers of ``sherman_tpu_torch.parallel.
transport`` and the plain version of the exchange kernel (K4) against the
JAX package's ``transport`` functions run under ``shard_map`` on the
virtual CPU mesh.

The JAX side runs each helper per node; the port takes the node-major
stack of every node's shard.  The exchange is held against both JAX
transports, ``exchange_impl="xla"`` (``lax.all_to_all``) and ``"pallas"``
(the remote-DMA kernel in interpret mode), which
tests/test_transport_pallas.py pins bit-identical to each other.  Inputs
are seeded numpy; every tolerance is exact equality.  On these CPU
tensors the exchange runs its plain version and counts no launch;
``tests/test_torch_cuda.py`` holds the CUDA kernel against it.
"""

import ctypes

import jax
import numpy as np
import pytest
import torch

from sherman_tpu.parallel import transport as JT
from sherman_tpu.parallel.mesh import AXIS, make_mesh
from sherman_tpu_torch.errors import ExchangeLaneError, KernelUnavailableError
from sherman_tpu_torch.ops import page_kernels as PK
from sherman_tpu_torch.parallel import transport as T
from sherman_tpu_torch.parallel import transport_kernel as TK

torch.set_num_threads(1)

SHAPES = [(4, 8, 16), (8, 4, 1)]


def _spmd(n, fn, *arrays):
    """Run ``fn`` per node over the node-sharded global arrays -> numpy
    (a tuple where ``fn`` returns one)."""
    spec = jax.sharding.PartitionSpec(AXIS)
    sm = jax.shard_map(fn, mesh=make_mesh(n),
                       in_specs=tuple(spec for _ in arrays),
                       out_specs=spec, check_vma=False)
    out = jax.jit(sm)(*arrays)
    return jax.tree.map(np.asarray, out)


def _nodes(x, n):
    """Global [N*R, ...] numpy -> the port's node-major [N, R, ...]."""
    return torch.from_numpy(np.ascontiguousarray(x)).view(
        (n, x.shape[0] // n) + x.shape[1:])


def _route_inputs(seed, n, c):
    rng = np.random.default_rng(seed)
    R = 3 * c + 5                  # enough rows to overflow some buckets
    dest = rng.integers(0, n + 2, n * R).astype(np.int32)   # some off-mesh
    dest[:c + 2] = 1               # one bucket of node 0 overflows
    active = rng.random(n * R) < 0.8
    return dest, active, R


@pytest.mark.parametrize("n,c,w", SHAPES)
def test_bucketize_and_scatter_match_jax(eight_devices, n, c, w):
    dest, active, R = _route_inputs(n * 10 + c, n, c)
    want_b, want_r = _spmd(n, lambda d, a: JT.bucketize(d, a, n, c),
                           dest, active)
    got_b, got_r = T.bucketize(_nodes(dest, n), _nodes(active, n), n, c)
    np.testing.assert_array_equal(got_b.reshape(-1).numpy(), want_b)
    np.testing.assert_array_equal(got_r.reshape(-1).numpy(), want_r)
    assert want_r.sum() < active.sum()             # overflow exercised
    rng = np.random.default_rng(c)
    field = rng.integers(-2**31, 2**31, (n * R, w), dtype=np.int64) \
        .astype(np.int32)
    if w == 1:
        field = field[:, 0]
    want = _spmd(n, lambda f, b: JT.scatter_to_buckets(f, b, n * c),
                 field, want_b)
    got = T.scatter_to_buckets(_nodes(field, n), got_b, n * c)
    assert got.shape == (n, n * c) + field.shape[1:]
    np.testing.assert_array_equal(got.reshape(want.shape).numpy(), want)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("n,c,w", SHAPES)
def test_exchange_matches_jax(eight_devices, n, c, w, impl):
    rng = np.random.default_rng(n + c + w)
    shape = (n * n * c, w) if w > 1 else (n * n * c,)
    x = rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)
    want = _spmd(n, lambda a: JT.exchange(a, AXIS, impl=impl), x)
    TK.reset_launches()
    got = T.exchange(_nodes(x, n))
    np.testing.assert_array_equal(got.reshape(want.shape).numpy(), want)
    # the plain version of K4 on the packed buffer is the same permutation
    packed = _nodes(x, n).reshape(n, n * c, -1)
    np.testing.assert_array_equal(TK.all_to_all_ref(packed).reshape(
        want.shape).numpy(), want)
    assert TK.LAUNCHES["exchange"] == 0


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_exchange_of_a_dict_keeps_every_dtype(eight_devices, impl):
    """A dict of int32 pages, bools and float32 (NaN payloads included)
    rides one packed buffer and comes back bit-exact, as JAX's does."""
    n, c = 4, 8
    rng = np.random.default_rng(1)
    tree = {
        "page": rng.integers(-2**31, 2**31, (n * n * c, 5),
                             dtype=np.int64).astype(np.int32),
        "ok": rng.integers(0, 2, n * n * c).astype(bool),
        "f": rng.integers(-2**31, 2**31, n * n * c, dtype=np.int64)
        .astype(np.int32).view(np.float32),
    }
    tree["f"][:3] = np.array([0x7FC00001, 0xFFA00000, 0x7F800000],
                             np.uint32).view(np.float32)   # NaNs, inf
    assert np.isnan(tree["f"]).any()
    want = _spmd(n, lambda t: JT.exchange(t, AXIS, impl=impl), tree)
    got = T.exchange({k: _nodes(v, n) for k, v in tree.items()})
    bits = lambda a: np.ascontiguousarray(a).view(np.uint8)
    for k, v in tree.items():
        g = got[k].reshape(v.shape).numpy()
        assert g.dtype == v.dtype, k
        np.testing.assert_array_equal(bits(g), bits(want[k]), err_msg=k)
    # the round trip: exchanging twice returns every field unchanged
    back = T.exchange(got)
    for k, v in tree.items():
        np.testing.assert_array_equal(bits(back[k].reshape(v.shape).numpy()),
                                      bits(v), err_msg=k)


def test_exchange_refuses_lanes_that_are_not_32_bits():
    n, c = 4, 8
    with pytest.raises(ExchangeLaneError) as ei:
        T.exchange({"a": torch.zeros((n, n * c), dtype=torch.int32),
                    "b": torch.zeros((n, n * c), dtype=torch.int16)})
    assert "int16" in str(ei.value) and "32-bit" in str(ei.value)
    assert isinstance(ei.value, TypeError)
    with pytest.raises(ExchangeLaneError):
        T.exchange(torch.zeros((n, n * c), dtype=torch.int64))


def test_gather_rows_and_take_local_match_jax(eight_devices):
    n, r = 8, 6
    rng = np.random.default_rng(4)
    x = rng.integers(-2**31, 2**31, (n * r, 4), dtype=np.int64) \
        .astype(np.int32)
    want = _spmd(n, lambda a: JT.gather_rows(a, AXIS)[None], x)
    got = T.gather_rows(_nodes(x, n))
    for node in range(n):              # every node receives the table
        np.testing.assert_array_equal(got.numpy(), want[node])
    idx = rng.integers(0, r, (n * 3,)).astype(np.int32)
    want = _spmd(n, lambda a, i: a[i], x, idx)
    got = T.take_local(_nodes(x, n), _nodes(idx, n).long())
    np.testing.assert_array_equal(got.reshape(want.shape).numpy(), want)


def test_exchange_launch_failure_is_typed_and_counts_no_launch(monkeypatch):
    """The exchange kernel is part of the one build, and a launch the
    runtime refuses raises with the CUDA error text."""
    assert any(s.endswith("parallel/csrc/exchange.cu") for s in PK.SOURCES)

    class FakeLib:
        @staticmethod
        def sherman_exchange(*args):
            ctypes.memmove(args[-2], b"CUDA error: too many blocks\x00", 28)
            return 1

    monkeypatch.setattr(PK, "load_library", lambda kernel="": FakeLib)
    TK.reset_launches()
    PK.reset_launches()
    with pytest.raises(KernelUnavailableError,
                       match="launch failed: CUDA error: too many blocks"):
        PK._call("exchange", "sherman_exchange", 0, None, None, 4, 8, 1,
                 launches=TK.LAUNCHES)
    assert TK.LAUNCHES["exchange"] == 0
    assert not any(PK.LAUNCHES.values())
