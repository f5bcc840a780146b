"""Port parity: K5, the spatially sharded windowed NMF, against the JAX ``windowed_nmf_multi_spatial``.

The JAX function runs on the 4-device virtual CPU mesh with its Pallas passes
in interpret mode, as ``tests/test_parallel.py`` runs it; the port's local
ring (all slabs in one process) and its distributed form (one gloo process
per slab) take the plain passes on CPU tensors.  jax is imported inside the
tests only: the spawned workers import this module and must not import jax.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import factorizer_tpu_torch as ftt
from factorizer_tpu_torch.ops.kernels import (
    windowed_nmf_multi_spatial,
    windowed_nmf_multi_spatial_local,
    windowed_nmf_multi_spatial_plain,
    windowed_nmf_plain,
)
from factorizer_tpu_torch.ops.kernels import windowed_sharded
from factorizer_tpu_torch.ops.kernels.windowed_sharded import (
    SlabSum,
    exchange_bytes,
    windowed_nmf_slab_backward_pass,
    windowed_nmf_slab_factors,
    windowed_nmf_slab_reconstruct,
    windowed_nmf_slab_tail,
)
from factorizer_tpu_torch.parallel import Slabs, initialize_distributed, make_mesh, run_processes
from factorizer_tpu_torch.utils.weights import flax_path

torch.set_num_threads(1)

SHAPE, D, P, ITERS = (1, 32, 16, 16, 8), 4, 4, 2
SHIFT_LISTS = {
    "jax_test": (None, 1, (2, 3, 1)),       # tests/test_parallel.py:175
    "s1_first": ((2, 3, 1), None, 1),        # the first pass already routes rows
    "s1_zero": (None, (0, 2, 3), (0, 1, 0)),  # dims 2 and 3 alone: no byte leaves a slab
    "one_shift": ((3, 0, 2),),               # a single pass: no scratch
}
BLOCK = dict(channels=8, spatial_size=(32, 16, 16), rank=1, num_iters=2, init_method="uniform", solver="hals", mlp_ratio=2)
SW = {"head_dim": 4, "patch_size": 4}


def _port_block(**kw):
    """The port's block with ``BLOCK``'s settings."""
    fact = {k: BLOCK[k] for k in ("rank", "num_iters", "init_method", "solver")}
    return ftt.FactorizerBlock(BLOCK["channels"], BLOCK["spatial_size"], mlp_ratio=BLOCK["mlp_ratio"],
                               reshape=(ftt.SWMatricize, SW), factorize_kwargs=fact, **kw)


def _data(dtype=np.float32):
    """The inputs of ``tests/test_parallel.py:158-166``."""
    rng = np.random.default_rng(11)
    x = rng.random(SHAPE, dtype=np.float32).astype(dtype)
    u0 = rng.random((D, 1), dtype=np.float32)
    v0 = rng.random((P**3, 1), dtype=np.float32)
    return x, u0, v0


def _slabs(x: np.ndarray, n: int, dtype=None, grad: bool = False) -> list:
    t = torch.from_numpy(x) if dtype is None else torch.from_numpy(x).to(dtype)
    return [c.contiguous().requires_grad_(grad) for c in t.chunk(n, 1)]


def _firsts(shifts) -> list:
    """Each shift's rows moved between slabs, its first component modulo the patch."""
    return [0 if s is None else (s if isinstance(s, int) else s[0]) % P for s in shifts]


def _sent(shifts, forward: bool, backward: bool, item: int = 4) -> int:
    """Bytes one slab of ``SHAPE`` / 4 hands to K5's exchanges: a halo of the largest s1 rows (the backward's of x
    and g), the routed factors (u and v's entries on the s1 rows of each first-row window) and the routed rows, f32."""
    row = int(np.prod(SHAPE[2:]))
    firsts = _firsts(shifts)
    factors = (SHAPE[2] // P) * (SHAPE[3] // P) * (SHAPE[4] // D) * sum(D + s1 * P**2 for s1 in firsts if s1)
    return (forward * (max(firsts) * row * item + 4 * factors)
            + backward * (2 * max(firsts) * row * item + 4 * sum(firsts) * row))


def _jax_sharded(x, u0, v0, shifts, solver="hals", num_grad_steps=None, cotangent=None):
    """JAX's K5 on the 4-device CPU mesh: the output, or dx for ``cotangent``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as Ps

    from factorizer_tpu.ops.pallas.windowed_sharded import windowed_nmf_multi_spatial as jax_k5
    from factorizer_tpu.parallel.mesh import make_mesh as jax_make_mesh

    mesh = jax_make_mesh({"model": 4})
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, Ps(None, "model")))
    fn = lambda t: jax_k5(t, jnp.asarray(u0), jnp.asarray(v0), D, P, shifts, solver, ITERS,
                          num_grad_steps=num_grad_steps, mesh=mesh, axis_name="model")
    if cotangent is None:
        return np.asarray(jax.jit(fn)(xs).astype(jnp.float32))
    return np.asarray(jax.jit(lambda t: jax.vjp(fn, t)[1](jnp.asarray(cotangent))[0])(xs))


@pytest.mark.parametrize("shifts", ["jax_test", "s1_first", "s1_zero"])
def test_forward_matches_jax_sharded(shifts):
    """Four slabs, f32, against JAX's K5 on the 4-device mesh: atol 2e-5 (summation order), as
    ``tests/test_parallel.py`` holds JAX's K5 to JAX's K1."""
    x, u0, v0 = _data()
    want = _jax_sharded(x, u0, v0, SHIFT_LISTS[shifts])
    ys = windowed_nmf_multi_spatial_local(_slabs(x, 4), torch.from_numpy(u0), torch.from_numpy(v0), D, P,
                                          SHIFT_LISTS[shifts], "hals", ITERS)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), want, atol=2e-5)


@pytest.mark.parametrize("solver,shifts,num_grad_steps", [
    ("hals", (None, 2), None),       # tests/test_parallel.py:196
    ("hals", ((2, 0, 1), None), None),
    ("mu", (None, 2), None),
    ("hals", (None, 2), 1),
])
def test_gradient_matches_jax_sharded(solver, shifts, num_grad_steps):
    """dx of sum(y^2) on four slabs, f32, against jax.vjp through JAX's K5: atol 2e-4, as ``tests/test_parallel.py``."""
    x, u0, v0 = _data()
    xs = _slabs(x, 4, grad=True)
    ys = windowed_nmf_multi_spatial_local(xs, torch.from_numpy(u0), torch.from_numpy(v0), D, P, shifts, solver, ITERS,
                                          1e-16, num_grad_steps)
    y = torch.cat(ys, 1)
    (y**2).sum().backward()
    want = _jax_sharded(x, u0, v0, shifts, solver, num_grad_steps, cotangent=2 * y.detach().numpy())
    np.testing.assert_allclose(torch.cat([t.grad for t in xs], 1).numpy(), want, atol=2e-4)


@pytest.mark.parametrize("num_grad_steps", [None, 0, 1])
@pytest.mark.parametrize("solver", ["hals", "mu"])
@pytest.mark.parametrize("ring", [1, 2, 4, 8])
def test_local_ring_f64_equals_k1_on_the_gathered_volume(ring, solver, num_grad_steps):
    """The semantic check in f64: any ring's joined output and dx against the port's ``windowed_nmf_plain`` on the
    whole volume, 1e-12; ``num_grad_steps=0`` gives exactly zero."""
    x, u0, v0 = _data(np.float64)
    u0, v0 = torch.from_numpy(u0), torch.from_numpy(v0)
    shifts = SHIFT_LISTS["s1_first"]
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(SHAPE))
    xs = _slabs(x, ring, grad=True)
    y = torch.cat(windowed_nmf_multi_spatial_local(xs, u0, v0, D, P, shifts, solver, ITERS, 1e-16, num_grad_steps), 1)
    y.backward(g)
    dx = torch.cat([t.grad for t in xs], 1)
    whole = torch.from_numpy(x).requires_grad_(True)
    ref = windowed_nmf_plain(whole, u0, v0, D, P, shifts, solver, ITERS, 1e-16, num_grad_steps)
    assert y.dtype == torch.float64
    np.testing.assert_allclose(y.detach().numpy(), ref.detach().numpy(), rtol=0, atol=1e-12)
    if num_grad_steps == 0:
        assert not dx.any()
    else:
        ref.backward(g)
        np.testing.assert_allclose(dx.numpy(), whole.grad.numpy(), rtol=0, atol=1e-12 * float(whole.grad.abs().max()))


@pytest.mark.parametrize("shifts", list(SHIFT_LISTS))
def test_shift_lists_and_bytes_sent(shifts):
    """Every shift list: the local ring equals K1's plain version on the whole volume bit for bit in f32, output and
    dx, the plain ring too; bytes travel only where a shift has s1 != 0: the forward one halo of the largest s1 rows
    out and the routed factors back, the backward the halos of x and g out and the routed f32 rows back."""
    x, u0, v0 = _data()
    u0, v0 = torch.from_numpy(u0), torch.from_numpy(v0)
    sh = SHIFT_LISTS[shifts]
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(SHAPE).astype(np.float32))
    xs = _slabs(x, 4, grad=True)
    before = windowed_nmf_multi_spatial.bytes_sent
    y = torch.cat(windowed_nmf_multi_spatial_local(xs, u0, v0, D, P, sh, "hals", ITERS), 1)
    forward = windowed_nmf_multi_spatial.bytes_sent - before
    y.backward(g)
    backward = windowed_nmf_multi_spatial.bytes_sent - before - forward
    assert (forward, backward) == (4 * _sent(sh, True, False), 4 * _sent(sh, False, True))
    whole = torch.from_numpy(x).requires_grad_(True)
    ref = windowed_nmf_plain(whole, u0, v0, D, P, sh, "hals", ITERS)
    ref.backward(g)
    np.testing.assert_array_equal(y.detach().numpy(), ref.detach().numpy())
    np.testing.assert_array_equal(torch.cat([t.grad for t in xs], 1).numpy(), whole.grad.numpy())
    plain = torch.cat(windowed_nmf_multi_spatial_plain(_slabs(x, 4), u0, v0, D, P, sh, "hals", ITERS), 1)
    np.testing.assert_array_equal(plain.numpy(), ref.detach().numpy())


@pytest.mark.parametrize("shifts", list(SHIFT_LISTS))
def test_bf16_ring_equals_k1_bit_for_bit(shifts):
    """bf16 slabs, every shift list: the ring's output and dx equal ``windowed_nmf_plain``'s and its autograd's on the
    whole volume bit for bit (the routed factors and rows are f32 and the passes sum in the same order)."""
    x, u0, v0 = _data()
    u0, v0 = torch.from_numpy(u0), torch.from_numpy(v0)
    sh = SHIFT_LISTS[shifts]
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(SHAPE).astype(np.float32)).bfloat16()
    xs = _slabs(x, 4, torch.bfloat16, grad=True)
    y = torch.cat(windowed_nmf_multi_spatial_local(xs, u0, v0, D, P, sh, "hals", ITERS), 1)
    y.backward(g)
    whole = torch.from_numpy(x).bfloat16().requires_grad_(True)
    ref = windowed_nmf_plain(whole, u0, v0, D, P, sh, "hals", ITERS)
    ref.backward(g)
    assert y.dtype == torch.bfloat16 and whole.grad.dtype == torch.bfloat16
    np.testing.assert_array_equal(y.detach().float().numpy(), ref.detach().float().numpy())
    np.testing.assert_array_equal(torch.cat([t.grad for t in xs], 1).float().numpy(), whole.grad.float().numpy())


@pytest.mark.parametrize("shifts", list(SHIFT_LISTS))
def test_exchanges_per_mixer(shifts, monkeypatch):
    """A mixer's forward makes 2 exchanges (the halo out, the routed factors back) and its backward 2 (the halos of
    x and g out, the routed rows back); none where no shift moves rows.  Counted in the local ring's exchange."""
    x, u0, v0 = _data()
    calls = []

    def counting(tensors, forward):
        calls.append(forward)
        return ring(tensors, forward)

    ring = windowed_sharded._local_ring
    monkeypatch.setattr(windowed_sharded, "_local_ring", counting)
    xs = _slabs(x, 4, grad=True)
    before = windowed_nmf_multi_spatial.exchanges
    y = torch.cat(windowed_nmf_multi_spatial_local(xs, torch.from_numpy(u0), torch.from_numpy(v0), D, P,
                                                   SHIFT_LISTS[shifts], "hals", ITERS), 1)
    forward = list(calls)
    y.sum().backward()
    moves = any(_firsts(SHIFT_LISTS[shifts]))
    assert forward == ([True, False] if moves else [])
    assert calls[len(forward):] == ([True, False] if moves else [])
    assert windowed_nmf_multi_spatial.exchanges - before == len(calls)


@pytest.mark.parametrize("ring", [2, 4])
def test_ordered_tail_keeps_pass_order(ring):
    """s1_first (the first pass routes rows, the second does not): on rings of 2 and 4, dx in f32 equals autograd
    through ``windowed_nmf_plain`` on the whole volume bit for bit, the slabs' last rows summed by the tail in the
    passes' order like every other row."""
    x, u0, v0 = _data()
    u0, v0 = torch.from_numpy(u0), torch.from_numpy(v0)
    sh = SHIFT_LISTS["s1_first"]
    g = torch.from_numpy(np.random.default_rng(7).standard_normal(SHAPE).astype(np.float32))
    xs = _slabs(x, ring, grad=True)
    torch.cat(windowed_nmf_multi_spatial_local(xs, u0, v0, D, P, sh, "hals", ITERS), 1).backward(g)
    whole = torch.from_numpy(x).requires_grad_(True)
    windowed_nmf_plain(whole, u0, v0, D, P, sh, "hals", ITERS).backward(g)
    np.testing.assert_array_equal(torch.cat([t.grad for t in xs], 1).numpy(), whole.grad.numpy())


class _Line:
    """One axis of ``n`` processes seen from the first: all that ``FactMixer.gathers`` reads of a mesh."""

    def __init__(self, n: int) -> None:
        self.n = n

    def axis_size(self, axis: str) -> int:
        return self.n

    def axis_index(self, axis: str) -> int:
        return 0


@pytest.mark.parametrize("world,whole,gathered", [(2, 32, False), (2, 8, True), (4, 32, False), (4, 16, False)])
def test_gather_rule_counts_the_bytes_sent(world, whole, gathered):
    """``FactMixer.gathers`` weighs K5's bytes as the exchanges count them: a small mixer's bytes per slab
    (``exchange_bytes``) equal ``bytes_sent`` of a forward and backward on a local ring, and the rule gathers where
    the all-gather's bytes fall below those counted (on 2 slabs of one patch each; on 4 slabs never)."""
    sw = {**SW, "shifts": list(SHIFT_LISTS["s1_first"])}
    kw = dict(reshape=(ftt.SWMatricize, sw), factorize_kwargs=dict(rank=1, num_iters=ITERS, init_method="uniform"))
    x, u0, v0 = _data()
    mixer = ftt.FactMixer(8, 8, (whole, 16, 16), **kw)
    mixer.slabs = Slabs(_Line(world), "model")
    xs = _slabs(x[:, :whole], world, grad=True)
    before = windowed_nmf_multi_spatial.bytes_sent
    y = torch.cat(windowed_nmf_multi_spatial_local(xs, torch.from_numpy(u0), torch.from_numpy(v0), *mixer.windowed,
                                                   "hals", ITERS), 1)
    y.sum().backward()
    counted = windowed_nmf_multi_spatial.bytes_sent - before
    assert world * exchange_bytes(xs[0].shape, 4, *mixer.windowed) == counted
    gather = 2 * (world - 1) * whole * xs[0][0, 0].numel() * 4
    assert mixer.gathers(xs[0].detach()) == (gather < counted) == gathered


def test_bf16_band():
    """bf16 slabs: the routed rows are f32 and the passes sum in f32, so the ring equals the port's K1 plain version
    on the whole volume bit for bit; JAX's K5 adds bf16 pass outputs, hence a band of two bf16 roundings against it
    (rtol and atol 2e-2, as K1's own bf16 test)."""
    x, u0, v0 = _data()
    sh = SHIFT_LISTS["jax_test"]
    u0t, v0t = torch.from_numpy(u0), torch.from_numpy(v0)
    ys = windowed_nmf_multi_spatial_local(_slabs(x, 4, torch.bfloat16), u0t, v0t, D, P, sh, "hals", ITERS)
    y = torch.cat(ys, 1)
    assert y.dtype == torch.bfloat16
    ref = windowed_nmf_plain(torch.from_numpy(x).bfloat16(), u0t, v0t, D, P, sh, "hals", ITERS)
    np.testing.assert_array_equal(y.float().numpy(), ref.float().numpy())
    import jax.numpy as jnp

    want = _jax_sharded(jnp.asarray(x, jnp.bfloat16), u0, v0, sh)
    np.testing.assert_allclose(y.float().numpy(), want, rtol=2e-2, atol=2e-2)


def test_passes_on_cpu_are_plain_and_count_nothing():
    """CPU slabs take the plain passes: no library is loaded, no launch counted.  Pass A gives K1's factors of the
    slab and the routed factors; pass B takes what arrived; a backward pass fills the body, its edge slot and its send
    slot, and the tail the slab's last rows."""
    x, u0, v0 = _data()
    u0, v0 = torch.from_numpy(u0), torch.from_numpy(v0)
    slab, left = _slabs(x, 2)
    shifts = ((3, 1, 0), None)
    counts = (windowed_nmf_multi_spatial.launches, windowed_nmf_multi_spatial.backward_launches,
              windowed_nmf_multi_spatial.tail_launches)
    U, V, route = windowed_nmf_slab_factors(slab, left[:, -3:].contiguous(), u0, v0, D, P, shifts, "hals", ITERS)
    assert U.shape == (2, 1, 4 * 4 * 4, 2, D) and V.shape == (2, 1, 64, 2, P**3)
    assert route.shape == (4 * 4 * 2 * (D + 3 * P**2),) and route.dtype == torch.float32
    y = windowed_nmf_slab_reconstruct(U, V, route, slab.shape, slab.dtype, D, P, shifts)
    assert y.shape == slab.shape and y.dtype == slab.dtype
    total = SlabSum(slab, [(3, 1, 0), (0, 0, 0)], plain=True)
    halos = torch.stack([left[:, -3:], left[:, -3:]])
    windowed_nmf_slab_backward_pass(slab, slab, halos, total, 1, u0, v0, D, P, "hals", ITERS, grad_steps=ITERS)
    windowed_nmf_slab_backward_pass(slab, slab, halos, total, 0, u0, v0, D, P, "hals", ITERS, grad_steps=ITERS)
    assert total.i == 2 and total.send.shape == (3 * 16 * 16 * 8,)
    windowed_nmf_slab_tail(total, torch.full_like(total.send, 7.0))
    assert bool((total.own[0][:, :] == 7).all()) and bool(torch.isfinite(total.out).all())
    assert counts == (windowed_nmf_multi_spatial.launches, windowed_nmf_multi_spatial.backward_launches,
                      windowed_nmf_multi_spatial.tail_launches)
    assert ftt.ops.kernels.build._state["lib"] is None


def test_errors_by_name():
    """A slab whose rows the patch does not divide, slabs of unequal shape but for their rows (unequal rows are a
    ring's unequal slabs), a non-contiguous slab."""
    x, u0, v0 = _data()
    u0, v0 = torch.from_numpy(u0), torch.from_numpy(v0)
    meta = torch.empty(1, 6, 16, 16, 8, device="meta")  # the check that the kernel path makes, without a card
    with pytest.raises(ValueError, match="CUDA tensors"):
        windowed_nmf_multi_spatial_local([meta, meta], u0.to("meta"), v0.to("meta"), D, P, (1,))
    from factorizer_tpu_torch.ops.kernels.windowed_sharded import _check_slab

    with pytest.raises(ValueError, match="a slab of 6 rows is no multiple of the patch 4"):
        _check_slab(torch.empty(1, 6, 16, 16, 8), (), (None,), u0, v0, D, P, 0, "hals")
    with pytest.raises(ValueError, match="needs a contiguous halo of shape"):
        _check_slab(torch.empty(1, 8, 16, 16, 8), (), (None,), u0, v0, D, P, 2, "hals")
    a, b = _slabs(x, 2)
    with pytest.raises(ValueError, match="share one shape"):
        windowed_nmf_multi_spatial_local([a, b[:, :, :8].contiguous()], u0, v0, D, P, (1,))


# --- the distributed form: one gloo process per slab ---------------------------------------------------------------


def _ring_worker(rank, world, init_method, x, u0, v0, g, shifts, solver):
    """This process's slab through the distributed entry point: output and dx."""
    torch.set_num_threads(1)
    initialize_distributed(init_method, world, rank, backend="gloo")
    mesh = make_mesh({"model": world})
    mine = torch.from_numpy(x).chunk(world, 1)[rank].contiguous().requires_grad_(True)
    y = windowed_nmf_multi_spatial(mine, torch.from_numpy(u0), torch.from_numpy(v0), D, P, shifts, solver, ITERS,
                                   mesh=mesh, axis_name="model")
    y.backward(torch.from_numpy(g).chunk(world, 1)[rank])
    return y.detach(), mine.grad, windowed_nmf_multi_spatial.bytes_sent


@pytest.fixture(scope="module")
def ring_of_four():
    x, u0, v0 = _data()
    g = np.random.default_rng(5).standard_normal(SHAPE).astype(np.float32)
    shifts = SHIFT_LISTS["s1_first"]
    results = run_processes(_ring_worker, 4, x, u0, v0, g, shifts, "hals", timeout=120)
    return x, u0, v0, g, shifts, results


@pytest.mark.parametrize("what", ["output", "dx"])
def test_four_gloo_processes_equal_the_local_ring(ring_of_four, what):
    """The distributed entry point in four gloo processes equals the local form exactly, forward and gradient:
    they differ in the exchange alone."""
    x, u0, v0, g, shifts, results = ring_of_four
    xs = _slabs(x, 4, grad=True)
    ys = windowed_nmf_multi_spatial_local(xs, torch.from_numpy(u0), torch.from_numpy(v0), D, P, shifts, "hals", ITERS)
    torch.cat(ys, 1).backward(torch.from_numpy(g))
    for rank, (y, dx, sent) in enumerate(results):
        got, want = (y, ys[rank].detach()) if what == "output" else (dx, xs[rank].grad)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        assert sent == _sent(shifts, True, True)  # forward: halo, factors back; backward: two halos, rows back


def _load_block(block, variables):
    """The JAX block's variables into the port's block through the bridge's rules (``utils/weights.py::flax_path``)."""
    state = {}
    for key, current in block.state_dict().items():
        collection, path, fn = flax_path("encoder.blocks.0.block.blocks.0." + key)
        node = variables[collection]
        for name in path[3:]:  # below unet.enc0.block0
            node = node[name]
        value = np.asarray(node) if fn is None else fn(np.asarray(node))
        state[key] = torch.tensor(np.ascontiguousarray(value)).to(current.dtype)
    block.load_state_dict(state, strict=True)
    return block


def _block_worker(rank, world, init_method, variables, x):
    """A ``FactorizerBlock`` with ``spatial_mesh`` on this process's slab: output and input gradient of sum(y^2)."""
    torch.set_num_threads(1)
    initialize_distributed(init_method, world, rank, backend="gloo")
    mesh = make_mesh({"model": world})
    block = _port_block(factorize_options={"spatial_mesh": mesh, "spatial_axis": "model"})
    _load_block(block, variables)
    with pytest.raises(ValueError, match="24 rows over 4 processes of axis 'model' do not give slabs of a whole number"):
        ftt.FactMixer(8, 8, (24, 16, 16), reshape=(ftt.SWMatricize, SW), factorize_kwargs={"rank": 1},
                      factorize_options={"spatial_mesh": mesh})
    mine = torch.from_numpy(x).chunk(world, 1)[rank].contiguous().requires_grad_(True)
    y = block(mine)
    (y**2).sum().backward()
    return y.detach(), mine.grad


def test_block_with_spatial_mesh_matches_jax():
    """The block of ``tests/test_parallel.py:216-244`` on four gloo processes, weights through the bridge, against
    the JAX block on the whole volume: output atol 1e-5; the input gradient against the port's own unsharded block,
    1e-5 of its largest entry."""
    import flax
    import jax
    import jax.numpy as jnp

    import factorizer_tpu as ftx

    blk = ftx.FactorizerBlock(**BLOCK, reshape=(ftx.SWMatricize, SW),
                              factorize_options={"use_pallas": True, "use_windowed": True})
    x = np.array(jax.random.uniform(jax.random.key(0), (1, 32, 16, 16, 8)))
    variables = jax.jit(blk.init)(jax.random.key(1), jnp.asarray(x))
    want = np.asarray(jax.jit(blk.apply)(variables, jnp.asarray(x)))
    variables = jax.tree.map(np.array, flax.core.unfreeze(dict(variables)))
    results = run_processes(_block_worker, 4, variables, x, timeout=120)
    got = torch.cat([y for y, _ in results], 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)

    whole = _load_block(_port_block(), variables)
    xt = torch.from_numpy(x).requires_grad_(True)
    (whole(xt) ** 2).sum().backward()
    dx = torch.cat([d for _, d in results], 1)
    assert (dx - xt.grad).abs().max() <= 1e-5 * xt.grad.abs().max()


@pytest.fixture
def mesh_of_one(tmp_path):
    """A one-process gloo group and its mesh: what a mixer's options are checked against."""
    initialize_distributed(f"file://{tmp_path}/rendezvous", 1, 0, backend="gloo")
    try:
        yield make_mesh({"model": 1})
    finally:
        dist.destroy_process_group()


def test_mixer_option_on_a_ring_of_one(mesh_of_one):
    """``spatial_mesh`` with one process: the mixer and a stage with a positional embedding equal the unsharded ones
    exactly; the options are no longer refused, the errors name what is wrong."""
    kw = dict(reshape=(ftt.SWMatricize, SW), factorize_kwargs=dict(rank=1, num_iters=2, init_method="uniform"))
    options = {"spatial_mesh": mesh_of_one, "spatial_axis": "model"}
    x = torch.from_numpy(_data()[0])
    plain = ftt.FactMixer(8, 8, (32, 16, 16), **kw)
    sharded = ftt.FactMixer(8, 8, (32, 16, 16), factorize_options=options, **kw)
    sharded.load_state_dict(plain.state_dict())
    assert sharded.spatial == (mesh_of_one, "model") and plain.spatial is None
    np.testing.assert_array_equal(sharded(x).detach().numpy(), plain(x).detach().numpy())
    with pytest.raises(ValueError, match="expected a slab of 32 rows"):
        sharded(x[:, :16].contiguous())

    stage_kw = dict(depth=1, pos_embed=True, mlp_ratio=2, **kw)
    stage = ftt.FactorizerStage(8, 8, (32, 16, 16), generator=torch.Generator().manual_seed(0), **stage_kw)
    stage_sp = ftt.FactorizerStage(8, 8, (32, 16, 16), factorize_options=options, **stage_kw)
    stage_sp.load_state_dict(stage.state_dict())
    np.testing.assert_array_equal(stage_sp(x).detach().numpy(), stage(x).detach().numpy())

    with pytest.raises(ValueError, match="needs a mixer that the windowed kernel computes"):
        ftt.FactMixer(8, 8, (32, 16, 16), reshape=kw["reshape"], factorize_kwargs={"rank": 2}, factorize_options=options)
    with pytest.raises(ValueError, match="needs a mixer that the windowed kernel computes"):
        ftt.FactMixer(8, 8, (32, 16, 16), factorize_options={**options, "use_windowed": False}, **kw)
    with pytest.raises(ValueError, match="not 'rows'"):
        ftt.FactMixer(8, 8, (32, 16, 16), factorize_options={"spatial_mesh": mesh_of_one, "spatial_axis": "rows"}, **kw)
