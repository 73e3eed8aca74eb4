"""The check fails what it must: the control (the reference with a
broken guarantee in the program's place) and the program with its timed
path broken underneath, each through the rest of a run (the harness's
look for a card skipped: on the CPU at a tiny size)."""

import time

import pytest

from portbench import harness

ONE = ["ycsb-100m.c-zipf", "ycsb-100m.a-zipf"]
EIGHT = ["sherman-64m-8mn.c-zipf", "sherman-64m-8mn.a-zipf",
         "sherman-64m-8mn.b-zipf"]
WRITES = ["ycsb-100m.a-zipf", "sherman-64m-8mn.a-zipf",
          "sherman-64m-8mn.b-zipf"]


def _run(spec, cell, **kw):
    return harness.run_cell(spec, cell, 2**33 + 1, 0.3, False, "cpu",
                            t_start=time.perf_counter(), **kw)


@pytest.mark.parametrize("cell", ONE + EIGHT)
def test_control_is_not_correct(tiny, cell):
    out = _run(tiny, cell, control=True, window_batches=3)
    assert not out["result"]["correct"]
    assert out["parts"]["wrong_reads"] > 0


@pytest.mark.parametrize("cell", WRITES)
def test_state_left_unchanged(tiny, cell, monkeypatch):
    """Every update acknowledged, none stored (K3 writes nothing)."""
    from sherman_tpu_torch.ops import page_kernels as PK
    monkeypatch.setattr(PK, "writeback", lambda pool, *a, **k: pool)
    out = _run(tiny, cell)
    assert not out["result"]["correct"]
    assert out["parts"]["lost_updates"] > 0


@pytest.mark.parametrize("cell", ONE + EIGHT)
def test_half_the_batch_left_out(tiny, cell, monkeypatch):
    """The serve drops every other row of every batch and reports them
    done (so no retry path sees them)."""
    from sherman_tpu_torch.models import batched

    def half(x):
        x = x.clone()
        x[1::2] = False
        return x

    search, mixed = batched.search_routed_spmd, batched.mixed_step_spmd

    def search_half(pool, counters, khi, klo, root, active, start, **kw):
        done, found, vhi, vlo = search(pool, counters, khi, klo, root,
                                       half(active), start, **kw)
        return done | active, found, vhi, vlo

    def mixed_half(pool, locks, counters, khi, klo, vhi, vlo, root, ar, aw,
                   start=None, **kw):
        st, done_r, found, rvh, rvl = mixed(pool, locks, counters, khi, klo,
                                            vhi, vlo, root, half(ar),
                                            half(aw), start, **kw)
        return st, done_r | ar, found, rvh, rvl

    monkeypatch.setattr(batched, "search_routed_spmd", search_half)
    monkeypatch.setattr(batched, "mixed_step_spmd", mixed_half)
    out = _run(tiny, cell)
    assert not out["result"]["correct"]
    assert out["parts"]["wrong_reads"] > 0


@pytest.mark.parametrize("cell", EIGHT)
def test_exchange_between_nodes_left_out(tiny, cell, monkeypatch):
    """Requests stay on their sender: each node serves its own block."""
    from sherman_tpu_torch.parallel import transport
    monkeypatch.setattr(transport, "exchange", lambda x, mesh=None: x)
    out = _run(tiny, cell)
    assert not out["result"]["correct"]
    # the descents never converge: the program raises and says so
    assert out["parts"]["unanswered"] > 0


@pytest.mark.parametrize("cell", ONE + EIGHT)
def test_an_answer_altered_where_it_is_produced(tiny, cell, monkeypatch):
    """The leaf search flips the low bit of the first row's value."""
    from sherman_tpu_torch.ops import layout
    find = layout.leaf_find_key

    def altered(pg, khi, klo):
        f, vh, vl, slot = find(pg, khi, klo)
        vl = vl.clone()
        vl[0] ^= 1
        return f, vh, vl, slot

    monkeypatch.setattr(layout, "leaf_find_key", altered)
    out = _run(tiny, cell)
    assert not out["result"]["correct"]
    assert out["parts"]["wrong_reads"] > 0


@pytest.mark.parametrize("cell", WRITES)
def test_batches_not_kept_still_hold_the_table(tiny, cell, monkeypatch):
    """With a share of the window's answers kept, the run is correct, and
    updates lost in batches not kept show in later reads."""
    import json
    p = tiny.root / "traffic" / f"{tiny.cell(cell)['traffic']}.json"
    t = json.loads(p.read_text())
    t["check_share"] = 0.3
    p.write_text(json.dumps(t))
    out = _run(tiny, cell)
    assert out["result"]["correct"], out["check"]
    from sherman_tpu_torch.ops import page_kernels as PK
    monkeypatch.setattr(PK, "writeback", lambda pool, *a, **k: pool)
    out = _run(tiny, cell)
    assert not out["result"]["correct"]
