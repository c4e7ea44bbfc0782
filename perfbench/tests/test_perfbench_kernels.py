"""Each kernel's byte count against the read set of its frozen plain copy,
and the copy against the program's own plain version, at a small size."""
import numpy as np
import pytest
import torch
import perfbench_testlib  # noqa: F401 — the import paths

from perfharness import keys, spec


def read_footprint(plain, args, kw, arrays) -> int:
    """Bytes of the distinct elements of ``arrays`` (name -> tensor passed
    in ``args``) that one call of ``plain`` reads, recorded from its
    indexing while it runs (``chip_smoke.py``'s ``read_footprint``)."""
    from torch.overrides import TorchFunctionMode

    seen = {name: [] for name in arrays}

    class Reads(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func is torch.Tensor.__getitem__ and isinstance(
                    args[1], torch.Tensor):
                for name, a in arrays.items():
                    if args[0] is a:
                        seen[name].append(args[1].reshape(-1))
            return func(*args, **(kwargs or {}))

    with Reads():
        plain(*args, **kw)
    return sum(
        int(torch.unique(torch.cat(idx)).numel()) * arrays[name].element_size()
        for name, idx in seen.items() if idx
    )


@pytest.fixture(scope="module")
def index():
    from repro_torch.core.uplif import UpLIF, UpLIFConfig

    k = keys.make_wikits(30_000, 9)
    ix = UpLIF(k[::2], k[::2] * 2 + 1, UpLIFConfig(bmat_capacity=1024),
               device="cpu")
    ix.insert(k[1:4000:2], k[1:4000:2])     # some of them overflow
    rng = np.random.default_rng(1)
    q = np.concatenate([rng.choice(k, 900), [0, k[-1] + 5, (1 << 62)]])
    return ix, torch.as_tensor(q.astype(np.int64))


def _k1_inputs(ix, q, sid=None):
    m = ix.rs_model
    args = (m.table, m.spline_keys, m.spline_pos, m.shift.reshape(1),
            ix.slots.keys, q)
    if sid is not None:
        args = args + (sid,)
    kw = dict(n_table=m.table.shape[0], n_knots=m.spline_keys.shape[0],
              cap=ix.capacity, window=ix.cfg.window,
              rs_iters=ix.rs_static.n_search_iters)
    return args, kw


def test_k1_bytes_are_the_plain_copys_reads(index):
    ix, q = index
    k1 = spec.kernel_module("k1")
    args, kw = _k1_inputs(ix, q)
    m = ix.rs_model
    arrays = dict(table=m.table, spline_keys=m.spline_keys,
                  spline_pos=m.spline_pos, shift=args[3],
                  slot_keys=ix.slots.keys)
    reads = read_footprint(k1.plain, args, kw, arrays)
    n = q.shape[0]
    assert k1.bytes_of(args, kw) == n * (8 + 16) + reads
    assert reads > n * 8          # every query reaches its own slots


def test_k1_copy_computes_what_the_program_does(index):
    from repro_torch.kernels.spline_lookup import fused_locate_plain

    ix, q = index
    k1 = spec.kernel_module("k1")
    args, kw = _k1_inputs(ix, q)
    j, start = k1.plain(*args, **kw)
    pj, pstart = fused_locate_plain(*args, **kw)
    assert torch.equal(j, pj) and torch.equal(start, pstart)
    # with shard ids (the router's stacked call), one shard
    sid = torch.zeros_like(q)
    args_s, _ = _k1_inputs(ix, q, sid)
    j2, _ = k1.plain(*args_s, **kw)
    assert torch.equal(j2, pj)
    assert k1.bytes_of(args_s, kw) == k1.bytes_of(args, kw) + 8 * q.shape[0]


def test_k2_bytes_are_the_plain_copys_reads(index):
    from repro_torch.kernels.bmat_rank import bmat_rank_plain

    ix, q = index
    k2 = spec.kernel_module("k2")
    b = ix.bmat.state
    assert int(b.size) > 0
    args = (b.keys, b.fences, q)
    kw = dict(cap=b.keys.shape[0], nf=b.fences.shape[0], fanout=16)
    reads = read_footprint(k2.plain, args, kw,
                           dict(keys=b.keys, fences=b.fences))
    assert k2.bytes_of(args, kw) == q.shape[0] * 16 + reads
    assert torch.equal(k2.plain(*args, **kw), bmat_rank_plain(*args, **kw))


def test_every_kernel_module_names_its_entry():
    import importlib

    for name, mod in spec.kernel_modules().items():
        assert mod.NAME == name
        target = importlib.import_module(mod.ENTRY[0])
        assert callable(getattr(target, mod.ENTRY[1]))


def test_k1_bytes_follow_the_interpolation_the_launch_asks_for():
    """Under the float32 position bound the caller may still ask K1 for
    float64 (``interp64``): the count is of what that launch reads."""
    from repro_torch.kernels.spline_lookup import fused_locate_plain

    k1 = spec.kernel_module("k1")
    cap, span = 1 << 20, 1 << 40        # one segment over [0, 2^40)
    model = (torch.tensor([0, 1, 1, 1], dtype=torch.int32),
             torch.tensor([0, span]),
             torch.tensor([0.0, cap - 1.0], dtype=torch.float64),
             torch.tensor([40], dtype=torch.int32),
             torch.arange(cap) * (span // cap))
    kw = dict(n_table=4, n_knots=2, cap=cap, window=64, rs_iters=1)
    kw64 = dict(kw, interp64=True)
    q = torch.randint(0, span, (200_000,),
                      generator=torch.Generator().manual_seed(0))
    # the queries whose windows float32 and float64 place apart
    q = q[fused_locate_plain(*model, q, **kw64)[1]
          != fused_locate_plain(*model, q, **kw)[1]]
    assert q.shape[0] > 0
    args = model + (q,)
    j, start = k1.plain(*args, **kw64)
    pj, pstart = fused_locate_plain(*args, **kw64)
    assert torch.equal(j, pj) and torch.equal(start, pstart)
    arrays = dict(zip(("table", "spline_keys", "spline_pos", "shift",
                       "slot_keys"), model))
    reads = read_footprint(k1.plain, args, kw64, arrays)
    assert k1.bytes_of(args, kw64) == q.shape[0] * (8 + 16) + reads
    assert k1.bytes_of(args, kw64) != k1.bytes_of(args, kw)


def test_the_probe_counts_k1_as_ops_calls_it(index):
    """The probe stands in for K1's wrapper, which ``ops.fused_locate``
    calls through its module with the interpolation it chose; the
    wrapper's launches are still counted on the wrapper itself."""
    from perfharness import probe
    from repro_torch.kernels import build, ops, spline_lookup

    ix, q = index
    k1 = spec.kernel_module("k1")
    args, kw = _k1_inputs(ix, q)
    entry = spline_lookup.fused_locate
    launches = entry.launches
    out = {}
    try:
        with probe.observe({"k1": k1}, out):
            assert spline_lookup.fused_locate is not entry
            ops.fused_locate(*args, **kw)
            build.count_launch(spline_lookup.fused_locate)
        assert spline_lookup.fused_locate is entry
        assert entry.launches == launches + 1
    finally:
        entry.launches = launches
    chosen = dict(kw, interp64=not ops.locate_fusable(kw["cap"],
                                                      kw["n_knots"]))
    assert out == {"k1": [k1.bytes_of(args, chosen)]}
