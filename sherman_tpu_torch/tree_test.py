"""Functional tree driver, ``test/tree_test.cpp`` parity (the port's
counterpart of ``tools/tree_test.py``).

The reference inserts 10,239 keys with v=i*2, overwrites with v=i*3,
asserts every search returns the overwrite, deletes a third, asserts the
deletes are gone and the rest intact, re-inserts and re-verifies
(``tree_test.cpp:30-67``).  The same sequence here, driven through the
batched engine on the card and spot-checked through the host Tree path
with the native index cache attached.

    python -m sherman_tpu_torch.tree_test [kNodeCount] [--n N] [--device]

``kNodeCount`` nodes are emulated on the card.  Prints ``tree_test PASS``;
``main(argv)`` returns ``{"metric": "tree_test", "ok": true, "keys",
"nodes", "host_path", "deleted", "structure"}``.  Without a card it exits
2 unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from sherman_tpu_torch import tools_common as TC


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="tree_test of the port")
    p.add_argument("kNodeCount", type=int, nargs="?", default=1)
    p.add_argument("--n", type=int, default=10_239)
    TC.add_device_arg(p)
    a = p.parse_args(argv)
    TC.require_device(a.device, "tree_test")

    from sherman_tpu_torch.models import batched
    from sherman_tpu_torch.utils import Timer, notify_error, notify_info

    n_nodes = a.kNodeCount
    cluster, tree, eng = TC.build_cluster(
        n_nodes, max(4096, TC.pages_for_keys(a.n) // n_nodes), 4096,
        chunk_pages=256, device=a.device)
    keys = TC.unique_keys(a.n, 3, hi=1 << 62, over=1.2)
    assert keys.shape[0] == a.n
    t = Timer()

    # insert v = k*2 (the bulk load: the warm-up path), then overwrite v = k*3
    t.begin()
    batched.bulk_load(tree, keys, keys * np.uint64(2))
    eng.attach_router()
    st = eng.insert(keys, keys * np.uint64(3))
    t.end_print(label=f"insert+overwrite {a.n} keys "
                f"(host_path={st['host_path']})")

    got, found = eng.search(keys)
    assert found.all(), f"{(~found).sum()} keys missing after overwrite"
    assert (got == keys * np.uint64(3)).all(), "overwrite not visible"
    notify_info("overwrite verified: v == k*3 for all %d keys", a.n)

    # delete every 3rd key
    dele = keys[::3]
    keep = np.setdiff1d(keys, dele)
    fnd = eng.delete(dele)
    assert fnd.all(), "delete: keys not found"
    _, found = eng.search(dele)
    assert not found.any(), "deleted keys still visible"
    got, found = eng.search(keep)
    assert found.all() and (got == keep * np.uint64(3)).all(), \
        "survivors corrupted by delete"
    notify_info("delete verified: %d gone, %d intact", len(dele), len(keep))

    # re-insert with v = k*5 and final verify
    eng.insert(dele, dele * np.uint64(5))
    got, found = eng.search(dele)
    assert found.all() and (got == dele * np.uint64(5)).all()
    got, found = eng.search(keep)
    assert found.all() and (got == keep * np.uint64(3)).all()

    # host-path spot check with the native index cache attached
    tree.enable_index_cache()
    dele_set = set(map(int, dele))
    for k in map(int, keys[:: max(1, a.n // 64)]):
        want = (k * (5 if k in dele_set else 3)) % (1 << 64)
        v = tree.search(k)
        if v != want:
            notify_error("host search mismatch at %d: %s != %d", k, v, want)
            raise SystemExit(1)

    stats = tree.check_structure()
    notify_info("structure: %s", stats)
    assert stats["keys"] == a.n
    print(f"tree_test PASS ({a.n} keys, {n_nodes} nodes)", flush=True)
    return {"metric": "tree_test", "ok": True, "keys": a.n,
            "nodes": n_nodes, "host_path": st["host_path"],
            "deleted": int(dele.size), "structure": stats}


if __name__ == "__main__":
    sys.exit(TC.run_cli(main))
