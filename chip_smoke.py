#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``sherman_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Drives the port's serving paths at the north-star size of ``bench.py``
(100 M keys, zipf 0.99) through the entry points a user calls — first on
one node, then on 8 nodes emulated on the card — and holds every CUDA
kernel of those paths against its plain PyTorch version:

1. build the kernels from ``sherman_tpu_torch/ops/csrc`` and
   ``sherman_tpu_torch/parallel/csrc``, and at the same time the earlier
   designs of K1 and K3 (``ops/csrc/baseline_kernels.cu``, the yardstick
   ``ms_before``) and a ``-Xptxas -v`` compile of the page kernels (the
   ``ptxas`` line: registers, shared memory, spills); check each kernel
   against its plain version on garbage inputs (exact equality): the page
   kernels K1-K3 on garbage pools (K3 also through a mask view that is
   not 16-byte aligned, and at one lane with rows sharing targets that
   carry equal values, the delete's clear), the exchange all-to-all K4 at
   several (N, C, W) and through its packer;
2. one node at 20,000 keys on the card and on the CPU from one seed:
   pools and counters bit-identical;
3. one node: bulk-load 100 M keys (``key = mix64(rank ^ salt)``, ``value
   = key ^ 0xDEADBEEF``, fill 0.75, a 4 GiB pool) and attach the router;
   YCSB-C ``search_combined`` on zipf 0.99 batches of 4,194,304 keys,
   every answer checked, plus a batch of absent keys; YCSB-A ``mixed``
   50/50 read/update zipf 0.99 batches of 1,048,576 keys, reads checked
   against the step rule (the pre-step value or this step's write), then
   every updated key searched for its last value;
4. K1-K3 replayed at every input shape phase 3 launched them at, on the
   inputs of that shape's first launch (K3: its first with an applied
   row; exact equality), timed with CUDA
   events beside their plain versions, a PyTorch library call where one
   computes the same function, and their device-memory bound; K1 and K3
   also in turns with their earlier designs (``ms_before``), with the
   host time of a wrapper call (``host_ms``); K1 with two ablations of
   its earlier design (every row inactive; the page fetch without the
   search), K3 with an empty mask; K1 from the root and K2 with its
   ``ok`` mask on real pages;
   one profiled step of each kind;
5. 8 nodes at 20,000 keys on the card and on the CPU from one seed:
   pools, locks and counters bit-identical;
6. 8 nodes: the same 100 M keys over ``machine_nr = 8`` pools of 524,288
   pages (4 GiB in all), the same YCSB-C and YCSB-A steps with every
   answer checked;
7. one untimed step of each kind: bucket overflows counted, a round-1
   page-reply exchange and a write-request exchange captured; K2-K4
   replayed at every shape phase 6 launched them at, as in phase 4 (K4
   on the captured buffers where their shape matches, else on random
   words of the shape: its work does not depend on the data); one
   profiled step of each kind.

The device-staged loops (``workload/device_prep.py``: zipf ranks,
keys, combining, router probe, serve and the check of every answer, all
on the card) run beside each path:

- before phase 3, and again before phase 6, the staged reference check
  at 20,000 keys on 1 and on 8 nodes: 3 steps each of staged YCSB-C
  (``aligned``, ``pipelined``) and YCSB-A (``chained``, ``pipelined``)
  with the quantile-table sampler on the card and on the plain path on
  the CPU — carries, pools, locks and counters bit-identical; then the
  analytic sampler on a fresh tree: equal receipts, and the count of
  ranks the card and the CPU draw differently;
- after phase 4, and again after phase 7, on the same tree (the keys
  the host-staged YCSB-A updated written back to their bulk values
  first): staged YCSB-C ``aligned`` and ``pipelined`` and staged YCSB-A
  50/50 ``chained`` and ``pipelined`` (batches of 4,194,304 and
  1,048,576 clients; 8 timed steps each on one node, 4 on 8 nodes),
  every receipt asserted; for each loop ops/s, ms per step, the
  per-phase times, the host syncs of one step and one profiled step;
  then every (kernel, shape) those windows launched replayed as in
  phase 4.

The fresh-insert split storm (``BatchedEngine.insert`` with device leaf
splits, ``flush_parents`` and the router's split notes), after phase 7,
in ``tools/insert_bench.py``'s configuration:

8. the storm reference check at 20,000 warm keys (fill 0.9) and 20,000
   fresh ones (``split_slots`` 256) on 1 node, 10,000 and 10,000 on 8
   nodes (for the time limit), card against the
   plain path on the CPU: stats, pools, locks and counters bit-identical,
   ``Tree.check_structure`` equal, every key found;
9. one node: 10,000,000 warm keys ``mix64(rank ^ 0x5E17AB1E5A17)``
   bulk-loaded at fill 0.9 (values ``key ^ 0xBEEF``) with the router, a
   524,288-page pool, then 3,000,000 fresh keys (the next ranks, shuffled
   with numpy seed 13): one warm-up chunk of 16,384 outside the timed
   window (its host syncs counted), the rest in chunks of 1,048,576
   through ``eng.insert`` (``split_slots`` 16,384, parents flushed once
   16,384 are pending); the ``storm`` line (the tool's fields, and the
   wall split into device rounds, ``_drain_split_log``,
   ``flush_parents`` and the rest of the host); every one of the 13 M
   keys searched with ``search_combined``; K1-K3 replayed at every shape
   the timed window launched, as in phase 4;
10. eight nodes: the same at 2,000,000 + 600,000 keys, 131,072 rows a
    node (``reduced`` in its line), K2-K4 replayed.

The drifting-keyspace churn (``BatchedEngine.delete``,
``reclaim_empty_leaves`` and write combining), after phase 10, in
``tools/churn_bench.py``'s documented configuration:

11. the churn reference check at 20,000 live keys of 16 streams, 6
    iterations of 2,000 fresh and 2,000 deleted keys with a reclaim pass
    each, on 1 and on 8 nodes (step capacity 32), card against the plain
    path on the CPU: found masks, stats, free lists, reclaim state,
    router tables, pools, locks and counters bit-identical, every live
    key found and the live slots counted exactly; then the storm
    reference check's inputs with write combining on, card and CPU,
    beside the card with it off: stats and pools equal, the combine
    counters of the card equal to the CPU's;
12. one node: 10,000,000 live keys of 4,096 append streams (``key =
    (i % 4096) << 44 | (i // 4096 + 1)``, values ``key ^ 0xBEEF``)
    bulk-loaded at fill 0.5 with the router into a 613,012-page pool;
    a warm-up outside the window (a 16,384-key insert, its delete, whose
    rounds and host syncs are counted, a reclaim pass); then 4 timed
    iterations: the next 524,288-key window inserted in 4 ascending
    chunks of 131,072 (each shuffled, 24 rounds), the oldest window
    deleted in 4 chunks, one reclaim pass; the ``churn`` line (the tool's
    fields, the wall split into insert, delete, reclaim and its parent
    removal); every live key searched with ``search_combined``, 10,000
    keys of the last deleted window probed, and the live slots of
    ``leaf_chain_info`` counted against the 10,000,000 live keys;
13. K1-K3 replayed at every shape the churn window launched, as in
    phase 4 (the 131,072-row delete snapshot, the one-lane clear).

The YCSB A-F matrix (``sherman_tpu_torch.ycsb_bench``, the port's copy of
``tools/ycsb_bench.py``: A/B through ``mixed``, C and D's reads through
``search_combined``, D/E inserts and F's writes through ``insert``, E's
scans through ``range_query_many``), after phase 13:

14. the YCSB reference check at 20,000 keys on 1 and on 8 nodes (step
    capacity 32 on 8), card against the plain path on the CPU:
    ``ycsb_bench.build``, then A-F in order, 2,048 ops a step, 4 batches
    each from one batch stream: the counts, every scan's (keys, values),
    the pools, locks and counters bit-identical, and every scan equal to
    a host mirror of the live set (bulk keys, D/E inserts, the values
    A/B/F wrote);
15. one node at the tool's configuration at 100,000,000 keys
    (``build`` and ``main``'s defaults): keys ``mix64(rank ^
    0x5E17AB1E5A17)``, values ``key ^ 0xD00D``, a 4,194,304-page pool
    (sized for the D/E inserts), step capacity 8,192, 8,192 rows a
    node, sibling chase budget 2, the router; A-F in order on one tree,
    8,192 ops a step, theta 0.99, one warm-up batch and 8 timed steps
    each; the ``ycsb_matrix`` line (the tool's rows, E's timed wall
    split into the router candidates, the K2 prefetch with its copy to
    the host, and the per-range walk, with the chain-gap reads and
    re-descents counted); every scan of E's timed steps checked against
    the host mirror outside the timed wall; K1-K3 replayed at every shape
    the window launched, as in phase 4, each scan prefetch as a K2 shape
    of its own (``site`` ``scan_prefetch``);
16. eight nodes: the same at 10,000,000 keys (1,024 rows a node;
    ``reduced`` in its line), K2-K4 replayed.

The integrity plane (``models/validate.py``'s ``check_structure_device``
and ``scrub_pass``, ``models/scrub.py``'s ``Scrubber``, ``chaos.py``'s
``FaultPlan``, degraded mode), after phase 16 (phase 18 rides the storm
and churn trees of phases 9, 10 and 12, after their timed windows):

17. the integrity reference check at 20,000 keys (numpy seed 42) on 1
    and on 8 nodes (step capacity 32 on 8), card against the plain path
    on the CPU: a bulk load of three keys in four, the fourth inserted,
    every sixth key and a band of 3,000 deleted, three reclaim passes
    (retired, parked and freed pages); the validator and the scrub pass;
    each of the five fault kinds through ``install_chaos`` (replies,
    plans, pools, locks, counters, dirty rows); a ``Scrubber`` over an
    entry-level fault (quarantine, the typed lock timeout) and a
    structural one (degraded mode, the typed refusal), the flagged pages'
    keys searched, the repair; eight iterations of
    ``tests/test_fuzz.py``'s chaos fuzz, reads checked against a model —
    every result and state bit-identical;
18. ``check_structure_device`` on the one-node storm tree (13,000,000
    keys), the eight-node one (2,600,000) and the churn tree after its
    last reclaim pass (10,000,000 live, the free-pool mask in play), each
    timed outside its window's wall;
19. on phase 15's 100 M-key tree after A-F (4,194,304 pages): the
    validator and a clean scrub, each timed (CUDA-event span, wall, peak
    device memory, bound); ``flip_entry_ver`` on a leaf, flagged and
    quarantined without degrading, an 8,192-key insert landing but for
    the fenced pages, the victim key's typed lock timeout; ``torn_page``
    on a second leaf, the engine degraded, ``insert``, ``delete``, a
    writing ``mixed`` and ``reclaim_empty_leaves`` refused, a zipf 0.99
    batch (less the flagged pages' keys) read by ``search_combined`` and
    an all-read ``mixed`` as the live mirror says; the repair (undo, a
    green validation, a clean scrub, the quarantine released, degraded
    mode left); a dead lease wedged on a leaf of the next 8,192-key
    batch, the batch landing through the engine's lease revocation and
    read back; the ``integrity`` JSON line (every pass of phases 18-19,
    the violation classes, the card); K1-K3 replayed at every shape the
    window launched (path ``one_node_integrity``).

The durability plane (``utils/journal.py``'s op journal,
``utils/checkpoint.py``'s full and delta checkpoints in the JAX package's
npz format, ``recovery.py``'s ``RecoveryPlane``), after phase 19:

20. the durability reference check at 20,000 keys (numpy seed 42, phase
    17's tree with retired, parked and freed pages) on 1 and on 8 nodes
    (step capacity 32 on 8), card against the plain path on the CPU: a
    ``RecoveryPlane`` (group commit 2 ms) and its base; acknowledged
    ``insert``, ``mixed`` and ``delete`` batches; ``reclaim_empty_leaves``;
    a delta; more batches; a torn half-record; ``recover``; ``torn_page``
    and ``flip_entry_ver`` on two leaves, a ``Scrubber`` pass and
    ``targeted_repair`` — the journal segment byte-identical, the delta's
    rows and pages, the recovered and repaired pools, locks, counters and
    directories bit-identical, RPO 0 over every acknowledged key on both;
21. on phase 15's 100 M-key tree after phase 19,
    ``tools/recovery_drill.py``'s sequence at ``tools/ckpt_bench.py``'s
    sizes, in a temporary directory (free disk checked first): the base
    save, its wall split into the device-to-host copy, the CRCs,
    ``savez_compressed`` with the write and the fsyncs; 8 batches of
    8,192 fresh inserts, 8 all-write ``mixed`` batches of 8,192 zipf 0.99
    updates and one ``delete`` of a zipf batch, every ack in the host
    ledger; the journal's appends, rows, fsyncs and bytes and the ack
    time it adds (one batch with it attached and detached, in turns);
    1,000,000 clustered upserts (the first keys in key order) and the
    delta beside the full save; more batches, a torn half-record, the
    crash (engine, tree and cluster dropped, device memory freed) and
    ``RecoveryPlane.recover`` (restore, replay, re-base: the RTO); RPO 0
    over the ledger, the torn keys absent and the tail cut once, a probe
    of 200,000 bulk keys, ``check_structure_device``; new traffic,
    ``torn_page`` and ``flip_entry_ver`` on live leaves, the scrubber's
    quarantine and degrade, ``targeted_repair`` with no full restore,
    the ledger and the victim pages' keys read again; the journal
    group-commit A/B of ``ckpt_bench`` (4 writers x 24 records); the
    ``durability`` JSON line; K1-K3 replayed at every shape of its three
    launch windows (path ``one_node_durability``).

The observability plane (``sherman_tpu_torch/obs``: the registry and its
pull collectors, spans, SLO telemetry, the flight recorder, the
exporters and the program ledger), after phase 21; its hooks run inside
every earlier phase, and the black box's bundles go to a temporary
``SHERMAN_BLACKBOX_DIR`` for the whole run:

22. (e, taken first) the recorder dumped and read back: phases 19-21 left
    ``chaos.inject``, ``scrub.violation``, ``scrub.quarantine``,
    ``engine.degraded_enter``, ``recovery.targeted_repair_begin``,
    ``engine.degraded_exit`` and ``recovery.targeted_repair`` in that
    order (the reference's drill order), phase 21 its ``recovery.*`` and
    ``checkpoint.*`` events, and a degraded entry an auto-dump bundle;
    (a) the obs reference check at 20,000 keys (numpy seed 42) on 1 and
    on 8 nodes (step capacity 32 on 8), card against the plain path on
    the CPU, through :func:`obs_run` — registry deltas, flight events,
    span names and counts, SLO counts and ledger programs equal, and on
    the card ``kernels.*_launches`` equal to ``LAUNCHES``; then on phase
    21's recovered 100 M-key tree (4,194,304 pages): (b-a) staged YCSB-C
    ``aligned`` (4,194,304 clients) and YCSB-A ``chained`` (1,048,576),
    obs on (``SHERMAN_SLO``, ``SHERMAN_DEVICE_OBS``) and off interleaved,
    3 windows of 8 steps a side, the ledger sealed around each window
    (``device.retraces`` 0), the host syncs of a step equal on both
    sides; (b-b) the matrix's YCSB-A ``mixed`` steps of 8,192 ops the
    same way (9 windows a side), with the cost of one span and of one SLO
    observation; (c)
    one snapshot against the smoke's own counts (``dsm.*`` against
    ``counter_snapshot``, ``slo.*`` ops, ``kernels.*`` against
    ``LAUNCHES``, the pool's 4,294,967,296 bytes beside
    ``torch.cuda.memory_allocated``), its Prometheus text and a JSONL
    snapshot written and parsed back; (d) the tracer's Chrome trace of
    one YCSB-A step reloaded, and ``obs.device_trace`` of one staged step
    naming K1-K3; (f) the ``obs`` JSON line, and K1-K3 replayed at every
    shape the phase launched (path ``one_node_obs``).

The hot-key leaf cache and the value heap (``models/leaf_cache.py``,
``models/value_heap.py``), after phase 22:

23. (a) the cache reference check on 1 and on 8 nodes, card against the
    plain path on the CPU (:func:`_cache_run`: cached search equal to the
    uncached, the combined search, ``mixed``, ``insert``, ``delete``,
    reclaim's unlink map, auto-admission, a scrub quarantine, the
    sidecar, the degraded flush — answers, mirrors, stats, device tables,
    pools and counters bit-identical); (b) on phase 15's 100 M-key tree
    a 65,536-slot cache filled with the hottest ranks, the staged YCSB-C
    ``aligned`` step at 4,194,304 clients with the cache (residual cap
    from two warm-up steps) and without, 3 windows of 8 steps a side
    interleaved and sealed: receipts equal, the measured hit ratio beside
    ``expected_hit_ratio``, ms a step, the phase profile with
    ``cache_probe``, host syncs a step; one host-path ``search_combined``
    of 4,194,304 zipf keys equal with and without the cache; the
    ``cache`` JSON line, K1 and K2 replayed at every shape (path
    ``one_node_cache``);
24. (a) the heap reference check on 1 and on 8 nodes, card against the
    CPU (:func:`_heap_run`: puts, gets with and without the cache, scans,
    overwrites, removes, a double free, scrub, rebuild, a checkpoint
    chain, a torn tail, a crash and ``recover`` — payloads, heap regions,
    allocators, journal bytes and the recovered state bit-identical, RPO
    0); (b) ``tools/ycsb_bench.py --value-bytes 64 --value-dist fixed``
    on phase 15's configuration at 2,000,000 keys with 300,000 heap pages
    (the keys halved past the smoke's projection): the migration of every record out of line, A-F through the
    heap (C sealed), every get and scan answer checked against the
    records' bytes, ``heap_phase_ms``, ``audit_ok``; the ``--ab`` YCSB-C
    arms on fresh trees of 1,000,000 keys; the heap tree through a base,
    acked puts and removes, a delta, a crash and
    ``recover`` (RPO 0, every get equal); the ``ycsb_matrix_heap`` JSON
    line, K1-K3 replayed at every shape (path ``one_node_heap``);
25. the serving front door (``make_ingress_step``, ``serve.py``,
    ``audit.py``, ``serve_bench.py``), after phase 24: (a) the front-door
    reference check on 1 and on 8 nodes (step capacity 32), card against
    the CPU at 20,000 keys (:func:`_front_run`: the ingress step on host
    and device prep at three rungs against ``search_combined``, partial,
    all-duplicate, full and single-key batches, stragglers after an
    insert storm, a cache attached, the device prep's six outputs against
    the host staging; a serial ``ShermanServer`` sequence with a journal
    and an ``Auditor`` — reads, rid inserts and a retried rid re-acked,
    deletes, a scan, a degraded entry shedding writes while reads serve,
    a deadline shed, payloads through the value heap — answers, pools,
    journal bytes, dedup windows and the heap bit-identical, the audit
    clean); (b) ``serve_bench`` at ``BENCHMARKS.md:130-133``'s
    configuration (100,000,000 keys, widths 262,144 / 1,048,576 /
    4,194,304, 65,536-op requests, 30 s, theta 0.99, 3 paced tenants and
    the greedy one, rho 0.6, ``pipelined``, group commit 2 ms) with the
    host syncs of one dispatch and one complete at each rung; (c) on that
    tree the host-vs-device prep A/B at each rung, then ``serve_bench``
    again with ``SHERMAN_PREP_IMPL=device`` and an ``Auditor``
    (sample_mod 8); (d) ``run_crash_drill`` at 100,000,000 keys, 4
    writers, group commit 2 ms, 10 s (RPO 0, acks per fsync above 1); the
    ``serve_bench``, ``serve_bench_device_prep`` and
    ``serve_crash_drill`` JSON lines, K1-K3 replayed at every shape
    (paths ``one_node_serve`` for (b)+(c), ``one_node_crash`` for (d));
26. the replication plane (``replica.py``, the ``repl_*`` chaos layer,
    the quorum gate, ``failover_drill.py``, ``partition_drill.py``),
    after phase 25: (a) the replication reference check on 1 and on 8
    nodes, card against the CPU at 3,000 keys (:func:`_repl_run`: ship,
    a sweeping delta and the re-bootstraps, replica reads served and
    forwarded, a ``ReplChaos.storm`` and its detections, quorum waits
    covered and timed out, an anti-entropy divergence repaired, a front
    door with rids, the split-brain fence point and its suffix count, the
    promotion, ``seed_dedup`` and the retried rids — pools, watermarks,
    windows, tails and counters bit-identical); (b) the failover drill at
    100,000,000 keys, one node, two followers, 30 s (``lost_acks``,
    ``duplicate_acks`` 0, linearizable, ``fenced_writes`` >= 1, two
    re-bootstraps; lag, availability gap, promotion, each bootstrap by
    part, device memory); (c) the partition drill at 10,000,000 keys,
    seed 11, 20 rounds (every injection detected or refused, no fenced
    ack merged, no diverged follower left, no lost or duplicate ack,
    linearizable; the quorum A/B and the re-join catch-up); the
    ``failover_drill`` and ``partition_drill`` JSON lines, K1-K3 replayed
    at every shape (paths ``one_node_failover``, ``one_node_partition``);
27. elastic resize (``utils/reshard.py``, ``migrate.py``, the DSM's dirty
    sinks, ``reshard_drill.py``, ``contract_drill.py``), after phase 26:
    (a) the resize sequence at 4,000 keys, 1 -> 4 and 4 -> 6 nodes, the
    heap off and on, card against the CPU (:func:`resize_run`: grow under
    traffic, a delta with the dirty sink, a crash, ``resume``, the
    cutover, the offline reshard, the restore at the target — emitted
    arrays, artifacts by seq, ``migrate.*`` counters and the restored tree
    bit-identical; the card's kernel shapes replayed exact); (b) the
    reshard drill, one node to four, ``--batch-pages 32``, and (c) the
    contract drill, two nodes to three, at 1,000,000 keys (in
    ``reduced``; (c) to 100,000 past the time budget): no lost ack, RPO 0, bit-identical, resume verified; no
    duplicate or lost ack, linearizable, no retrace; the
    ``reshard_drill`` and ``contract_drill`` JSON lines, K1-K4 replayed
    at every shape (paths
    ``one_node_reshard``, ``two_node_contract``), the certification
    gather's K2 shape among them;
28. the multihost service plane and host failover (``multihost.py``, the
    per-host chains and ``recover_union`` of ``recovery.py``, the
    cross-host tail of ``replica.py``, ``hostlease.py``, ``HostChaos``),
    after phase 27: (a) two sequences at the drills' 4,000 keys, two
    hosts of one node, with no thread, card against the CPU
    (:func:`host_plane_run`: the routed door's split and merge with rids,
    per-host deltas, host 0's torn tail, ``recover_union``, host 0's
    re-base sweeping only ``-h0-``, the cross-host tail;
    :func:`host_fail_run`: leases, a freeze, detection, the fence point,
    the adoption, the zombie's fenced suffix and typed refusal, the
    hand-back — answers, pools, artifact names and journal bytes with the
    chain ids by role, receipts, counters and merged stats bit-identical;
    the card's kernel shapes replayed exact); (b) the multihost drill,
    two hosts, at 100,000,000 keys (``rpo_ops``, ``lost_acks`` 0,
    linearizable, the ack-bandwidth A/B >= 1.5x), and (c) the hostfail
    drill, two hosts, lease 0.5 s, at 100,000,000 keys (``lost_acks``,
    ``duplicate_acks``, ``fenced_acks_merged``, ``unadopted_dead_hosts``
    0, linearizable; ``detect_ms``, ``adoption_ms``,
    ``availability_gap_ms``), each cut to 10,000,000 and then 1,000,000
    keys past the time budget ((c) first, each listed in ``reduced``); the
    ``multihost_drill`` and ``hostfail_drill`` JSON lines, K1-K3 replayed
    at every shape (paths ``two_host_multihost``, ``two_host_hostfail``);
29. the native host tier (``sherman_tpu_torch/native``: ``BatchPrep``,
    ``ZipfGen``, ``IndexCache``, ``LocalLockTable``, ``WRLock``,
    ``LatencyHistogram``; built with g++ at the start beside nvcc, and the
    smoke fails with ``NativeUnavailableError`` where it cannot load), run
    after phase 4 on phase 3's tree: (a) at 20,000 keys on the card and on
    the CPU from one seed (:func:`native_run`: ``BatchPrep``-staged
    batches through ``_get_search_fanout``, a host ``Tree`` with the index
    cache through fresh inserts that split leaves, a seeded single-client
    lock sequence — answers, prep buffers, cache stats, ``btree.cache_*``
    deltas, lock counts, pools and counters bit-identical), then the
    threaded lock counter on the card (4 clients: the counter exact, the
    global CAS and unlocks under half the ops); (b) on phase 3's 100 M-key
    tree, its values written back to ``key ^ 0xDEADBEEF``, the bench's
    host-staged half (``bench.host_staged``: three sizing passes, the
    warm-up, 16 host-staged sustained steps (8 past the budget), 4
    start-sorted batches, 64 synced latency spans into the histogram, the
    host per-op floor; every answer checked) and its ``native_host`` JSON
    line; (c) every shape it launched replayed (path
    ``one_node_native``: K1; the one-node host steps run no page kernel).
31. the process-spanning transport, last (``parallel/mesh.py``,
    ``bootstrap.init_multihost``, ``ReplicatedDSM``, K4 around the gloo
    ``all_to_all``, the collective checkpoint, ``utils/failure.py``): the
    parent frees its trees and starts two rank processes of this script
    (``--rank R``, a free port, ``SHERMAN_COORD``/``NPROC``/``PROC_ID``)
    that share the card and load the kernels it built; their lines come
    back through pipes.  (a) 2 ranks x 4 nodes on the card at 20,000 keys
    against one process of 8 nodes on the CPU, from one seed
    (:func:`mr_parity_seq`: bulk load, insert with device splits, search,
    delete, the device validator, ``mixed``, the collective checkpoint and
    its restore, three staged aligned and three staged mixed steps):
    pools, locks, counters, answers and receipts bit-identical, and every
    K4 shape of each rank replayed exact; then the hot-key tier and the
    ingress step at 20,000 keys the same way (:data:`MR_SEQS`:
    :func:`mr_cache_seq`, a 4,096-slot cache, fill, three cached staged
    steps, cached ``search`` and ``search_combined``, an insert that
    rewrites and splits under cached keys, the re-search;
    :func:`mr_ingress_seq`, the ingress step with the prep on the host and
    on the device, with the cache, a batch of stale seeds that the rescue
    answers, and ``ShermanServer`` on one rung: start, three reads, stop),
    answers, receipts, cache stats, mirrors and device tables too; (b)
    the north-star keyspace
    (100 M keys, fill 0.75) over 2 ranks x 4 nodes of 524,288 pages:
    staged aligned YCSB-C at 4,194,304 ops a step (receipts summed over
    the ranks); a 65,536-slot cache filled with the hottest ranks and the
    same step with it (its residual cap from two warm-up steps; receipts
    equal to the uncached step's after as many steps, the hit ratio beside
    ``expected_hit_ratio``, ms a step of each side) and the ingress step
    at 65,536 (the prep on the host, on the device, with the cache; every
    answer checked), YCSB-A ``mixed`` at 1,048,576 (every read checked), a
    storm chunk of 81,920 fresh inserts with device splits (20 past the
    low fence of each of 4,096 neighbouring leaves; every key searched),
    the device validator, the collective checkpoint and its restore into
    a fresh two-rank cluster (1,048,576 sampled keys checked); ms a step
    beside phase 6's one-process staged step of this run, and the
    exchange's split (K4 device ms, staging device ms, gloo wall ms,
    bytes across ranks); window ``2r`` (K2-K4, the ranks' launches
    summed; K1 runs on no multi-node path; the ranks replay in turn, so
    each times its shapes alone on the card) and window ``2c`` (the same
    for the hot-key tier and the ingress step of 31a and 31b); (c) the
    failure plane at
    4,000 keys: rank 1 stopped (rank 0's guarded barrier raises
    ``PeerFailure`` naming it inside its deadline, both resume), SIGTERM
    on rank 0 (both checkpoint at one step), rank 1 killed (the heartbeat
    ends rank 0 with a diagnostic naming rank 1) and a relaunched pair
    restoring the checkpoint, every key checked.  Its ``multirank`` line
    has each number.  Budget: ``BUDGET["31"]``.
32. the port's linter (``sherman_tpu_torch/analysis``, a few seconds on
    the host): ``sherman_tpu_torch/`` and this script linted with the
    committed (empty) baseline; one ``lint`` JSON line (files, findings,
    pragmas by rule, ``lint_clean``), and the smoke fails unless the tree
    is clean.  It launches no kernel.

Launch counts are reset just before phase 3 and read just after it (K1,
K2 and K3 must launch), and again around phase 6 (K2, K3 and K4 must
launch), around each staged window, around each storm's timed window
(K1-K3 on one node; K2-K4 on eight), around the churn's timed window
(K1-K3), around each YCSB matrix (K1-K3 on one node; K2-K4 on eight),
around phase 19's serving steps (K1-K3), around phase 21's traffic
and delta, its recovery and its repair (K1-K3 in each), around phase
22b (K1-K3), around 23b (K1, K2), around 24b's migration and matrix
(K1-K3), around 25b+c and 25d, around 26b and 26c (K1-K3 in each), around
each of 27a's card runs (K2-K4), around 27b (K1-K4) and 27c (K2-K4),
around 28a's card runs and around 28b and 28c (K1-K3 in each), around
29b (K1), in each rank around 31a and 31b (K2-K4, window ``2r`` summing
31b's two ranks) and around their hot-key tier and ingress step (K2-K4,
window ``2c``);
in every window the launches are also counted by input shape.
Every time is the device time of one call (median of 21, plain versions
5): a spin kernel queued before the start event keeps the card busy
while the host enqueues the call, so a one-element ``fill_`` shows the
floor of the method (``launch_floor_ms``). A kernel's ``ms``,
``ms_before``, ``plain_ms``, ``library_ms`` and ``bound_ms`` are means
per launch over its shapes, each listed under ``shapes`` (and
``library_shapes`` the means over the shapes where the library call
computes the same function). The lines before the last are the
``integrity``, ``durability``, ``obs``, ``cache`` and
``ycsb_matrix_heap`` JSON records (printed after phases 19, 21, 22, 23
and 24), phase 25's ``serve_bench``, ``serve_bench_device_prep`` and
``serve_crash_drill`` records, phase 26's ``failover_drill`` and
``partition_drill`` records, phase 27's ``reshard_drill`` and
``contract_drill`` records, phase 28's ``multihost_drill`` and
``hostfail_drill`` records, phase 29's ``native_host`` record (printed
after phase 4), phase 32's ``lint`` record, the K1 and K3 ablations, the
``kernels`` JSON record
and the card's name and power limit; the last line is ``{"ok": true,
"device": {...}}``. Any failure raises: the script exits nonzero and
prints no ``ok`` line, also when no CUDA device is present.
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
import gc
import glob
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import weakref

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from sherman_tpu_torch.utils.timer import (  # noqa: E402  the one timer
    HBM_BYTES_PER_S, bound, host_ms, time_ab, time_ms)
STAGED_STEPS_8 = 4             # timed steps of each staged loop on 8 nodes
VAL_XOR = np.uint64(0xDEADBEEF)


_T0 = time.perf_counter()


def _log(msg: str) -> None:
    """One progress line, stamped with the seconds since the start."""
    print(f"[{time.perf_counter() - _T0:.1f} s] {msg}", flush=True)


# ---------------------------------------------------------------------------
# The time budget.
# ---------------------------------------------------------------------------

SMOKE_CUT_S = 1050.0            # the projection past which phases cut
#                                 depth (the smoke's limit is 1,200 s)
# The phases whose depth the budget sets, in run order: each one's seconds
# at full depth on the H100 (a whole smoke with no cut: 41, 153, 131 and
# 313 s of its 1,094.8 s; phase 28 alone, 240.8 s; phase 29, which runs
# after phase 4, 15.6 s alone), and its cuts in the order taken, as (key,
# the cut, the seconds it saves).  An earlier phase cuts first, apart
# from the last-resort cuts (:data:`LAST_CUTS`).
# Phase 30 (the drivers, ``tools_full_width``): its seconds at full depth
# and its cuts in order, each (key, the cut, the seconds it saves).
TOOLS_S = 70.0
TOOLS_CUTS = (
    ("staged_keys", "profile_staged2 KEYS 10,000,000 -> 1,000,000 and B "
     "4,194,304 -> 1,048,576", 15.0),
    ("lat_keys", "latency_bench --keys 10,000,000 -> 1,000,000", 10.0),
    ("rows", "profile_gather and profile_insert --rows 2,097,152 -> "
     "524,288 and --keys 2,000,000 -> 500,000", 8.0),
    ("write_n", "write_test --n 200,000 -> 50,000", 2.0))
BUDGET = {
    "29": (20.0, (
        ("b_steps", "(b) host-staged sustained steps 16 -> 8", 1.0),)),
    # phase 16's one-node matrix, whose tree phases 19-23 serve (its
    # build, the workloads, 21's saves, restores and repair scale with it)
    "16": (40.0, (("keys", "the one-node YCSB matrix's tree (phases 16 "
                   "and 19-23) 100,000,000 -> 10,000,000 keys", 80.0),)),
    "24b": (41.0, (("keys", "keys halved", 15.0),)),
    "25": (153.0, (
        ("c_secs", "(c)'s second serve run --secs 30 -> 10", 20.0),
        ("b_secs", "(b) --secs 30 -> 15", 15.0),
        ("d_secs", "(d) --secs 10 -> 5", 5.0),
        ("keys", "(b)-(d) keys 100,000,000 -> 10,000,000", 30.0))),
    "26": (131.0, (
        ("b_secs", "(b) --secs 30 -> 15", 15.0),
        ("c_keys", "(c) keys 10,000,000 -> 1,000,000", 12.0),
        ("b_keys", "(b) keys 100,000,000 -> 10,000,000 (the base saves "
         "and the followers' bootstraps scale with them)", 65.0))),
    "27": (313.0, (
        ("c_keys", "(c) keys 1,000,000 -> 100,000", 85.0),
        ("b_keys", "(b) keys 1,000,000 -> 100,000", 190.0))),
    "28": (245.0, (
        ("c_keys", "(c) keys 100,000,000 -> 10,000,000", 80.0),
        ("b_keys", "(b) keys 100,000,000 -> 10,000,000", 120.0),
        ("c_keys_1m", "(c) keys 10,000,000 -> 1,000,000", 6.0),
        ("b_keys_1m", "(b) keys 10,000,000 -> 1,000,000", 8.0))),
    "30": (TOOLS_S, TOOLS_CUTS),
    # phase 31, the two-rank transport (alone on the H100 at 100 M keys:
    # 202.0-210.6 s with the hot-key tier and the ingress step, 196.6 s
    # without them in the same call): 31b's cuts in order
    "31": (211.0, (
        ("ck_keys", "31b's checkpoint and restore at 10,000,000 keys", 20.0),
        ("steps", "31b's steps 4 -> 2", 5.0),
        ("c_steps", "31b's cached steps 4 -> 2", 2.0),
        ("keys", "31b's bulk load at 10,000,000 keys", 5.0))),
    # phase 32, the linter (~8-10 s on a host core), with no cut
    "32": (15.0, ()),
}
# The last-resort cuts, taken after every other cut (phase 31's too):
# (phase, key) -> the seconds from the phase's decision to the smoke's end
# with this cut and every other one taken (a whole smoke on the H100 with
# both taken and phase 31's hot-key tier and ingress step: 722 and 516 s).
# One is taken while that time, the seconds elapsed and what the cut
# saves pass SMOKE_CUT_S; phase 31 then takes all its cuts.
LAST_CUTS = {("16", "keys"): 725.0, ("25", "keys"): 520.0}
_last_taken: list = []          # the last-resort cuts this smoke took


def budget_cuts(phase: str, t_smoke: float) -> dict:
    """The cuts ``phase`` takes as it starts, in :data:`BUDGET`'s order:
    each while the projection (the seconds since ``t_smoke`` plus the
    estimates of ``phase`` and every later phase, less what the cuts
    taken save) passes ``SMOKE_CUT_S``; a cut of :data:`LAST_CUTS` by its
    own projection, and phase 31 every cut once one of those was taken.
    -> {key: its ``reduced`` line}."""
    elapsed = time.perf_counter() - t_smoke
    names = list(BUDGET)
    proj = elapsed + sum(BUDGET[p][0] for p in names[names.index(phase):])
    taken = {}
    for key, what, saves in BUDGET[phase][1]:
        rest = LAST_CUTS.get((phase, key))
        if rest is not None:
            last = elapsed + rest + saves
            if last > SMOKE_CUT_S:
                taken[key] = (f"{what}: the smoke's projection with every "
                              f"other cut taken {last:.0f} s passed "
                              f"{SMOKE_CUT_S:.0f} s")
                _last_taken.append(f"{phase} {key}")
        elif phase == "31" and _last_taken:
            taken[key] = (f"{what}: counted as taken by the last-resort "
                          f"cut(s) {', '.join(_last_taken)}")
        elif proj > SMOKE_CUT_S:
            taken[key] = (f"{what}: the smoke's projection {proj:.0f} s "
                          f"passed {SMOKE_CUT_S:.0f} s")
            proj -= saves
    return taken


def keys_of(ranks: np.ndarray, salt: int) -> np.ndarray:
    from sherman_tpu_torch.ops import bits
    return bits.mix64_np(np.asarray(ranks, np.uint64) ^ np.uint64(salt))


# ---------------------------------------------------------------------------
# The earlier designs of K1 and K3 (``ms_before``, the K1 ablations) and the
# compiler's report on every kernel, built with nvcc beside the extension.
# ---------------------------------------------------------------------------

ROOT = os.path.dirname(os.path.abspath(__file__))
BASELINE_SRC = "sherman_tpu_torch/ops/csrc/baseline_kernels.cu"
_PTXAS_KERNEL = re.compile(r"(descent_round_kernel|gather_pages_kernel|"
                           r"writeback_kernel)(?:I(?:Lb|Li)(\d+)E)?")


def start_nvcc_builds() -> dict:
    """Start nvcc on the baseline kernels (a ctypes library) and on
    page_kernels.cu alone with ``-Xptxas -v``, both at once; the
    extension's own build runs meanwhile.  -> {what: Popen}"""
    from torch.utils import cpp_extension
    from sherman_tpu_torch.ops import page_kernels as PK
    nvcc = os.path.join(cpp_extension.CUDA_HOME or "/usr/local/cuda", "bin",
                        "nvcc")
    os.makedirs(PK.BUILD_DIR, exist_ok=True)
    flags = [nvcc, "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xptxas", "-v"]
    out = {"baseline": flags + [
               "-shared", "-Xcompiler", "-fPIC", "-o",
               os.path.join(PK.BUILD_DIR, "libbaseline_kernels.so"),
               os.path.join(ROOT, BASELINE_SRC)],
           "page_kernels": flags + [
               "-c", "-o", os.path.join(PK.BUILD_DIR, "ptxas_report.o"),
               PK.SOURCES[1]]}
    return {k: subprocess.Popen(v, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
            for k, v in out.items()}


def finish_nvcc_builds(procs: dict) -> "Baseline":
    """Wait for :func:`start_nvcc_builds`, print each kernel's registers,
    shared memory and spills as ptxas reports them, and load the baseline
    library."""
    from sherman_tpu_torch.ops import page_kernels as PK
    report = {}
    for what, p in procs.items():
        text = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc ({what}) failed:\n{text}")
        name = None
        for line in text.splitlines():
            m = _PTXAS_KERNEL.search(line)
            if "Compiling entry function" in line and m:
                name = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
            elif name and "Used" in line:
                report[f"{what}:{name}"] = line.split(":", 1)[1].strip()
            elif name and "spill" in line:
                report[f"{what}:{name}:spill"] = line.strip()
    _log("ptxas: " + json.dumps(report))
    return Baseline(os.path.join(PK.BUILD_DIR, "libbaseline_kernels.so"))


class Baseline:
    """The earlier one-warp-per-row descent round (``mode`` 0; 1 is its
    fetch-only ablation) and one-thread-per-lane write-back, on the
    current stream; they count no launch."""

    def __init__(self, path: str):
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        self.lib = lib = ctypes.CDLL(path)
        lib.baseline_descent_round.argtypes = (
            [i32, p, i64, p, p, p, p, i64, i32] + [p] * 8)
        lib.baseline_writeback.argtypes = [p, i64, p, p, p, p, i64, i32, p, p]
        lib.baseline_descent_round.restype = i32
        lib.baseline_writeback.restype = i32

    @staticmethod
    def _ok(rc: int, what: str) -> None:
        if rc != 0:
            raise RuntimeError(f"baseline {what} launch failed: CUDA error "
                               f"{rc}")

    def descent_round(self, pool, addr, khi, klo, active, *, stop_level=0,
                      mode=0):
        B, dev = addr.shape[0], pool.device
        outs = [torch.empty(B, dtype=dt, device=dev) for dt in
                (torch.int32,) + (torch.bool,) * 4 + (torch.int32,) * 2]
        self._ok(self.lib.baseline_descent_round(
            mode, pool.data_ptr(), pool.shape[0], addr.data_ptr(),
            khi.data_ptr(), klo.data_ptr(), active.data_ptr(), B,
            int(stop_level), *[o.data_ptr() for o in outs],
            torch.cuda.current_stream().cuda_stream), "descent_round")
        return tuple(outs)

    def writeback(self, pool, page, slot, applied, ent, field_w):
        fw = (ctypes.c_int * 5)(*[int(w) for w in field_w])
        self._ok(self.lib.baseline_writeback(
            pool.data_ptr(), pool.shape[0], page.data_ptr(), slot.data_ptr(),
            applied.data_ptr(), ent.data_ptr(), page.shape[0], len(field_w),
            ctypes.cast(fw, ctypes.c_void_p),
            torch.cuda.current_stream().cuda_stream), "writeback")
        return pool


BASELINE: Baseline | None = None      # set by main() after the build


# largest |kernel - plain| seen per kernel; every check requires 0
MAX_ERR = {"descent_round": 0, "gather_pages": 0, "writeback": 0,
           "exchange": 0}


def _max_abs(x: torch.Tensor, y: torch.Tensor) -> int:
    """max |x - y| over integer tensors of the same shape, in slices of
    the leading dimension (the exchange buffers are several GB)."""
    if torch.equal(x, y):
        return 0
    x, y = x.reshape(x.shape[0], -1), y.reshape(y.shape[0], -1)
    step = max(1, (1 << 26) // max(1, x.shape[1]))
    return max(int((x[i:i + step].long() - y[i:i + step].long()).abs().max())
               for i in range(0, x.shape[0], step))


def _eq(a, b, what: str) -> None:
    """Exact equality of a kernel's outputs with its plain version's."""
    pairs = zip(a, b) if isinstance(a, tuple) else ((a, b),)
    err = max(_max_abs(x, y) if x.numel() else 0 for x, y in pairs)
    kernel = what.split()[0]
    MAX_ERR[kernel] = max(MAX_ERR[kernel], err)
    if err != 0:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{what} (max abs err {err})")


# ---------------------------------------------------------------------------
# Phase 1: build + parity on garbage pools.
# ---------------------------------------------------------------------------

def garbage_parity(dev) -> None:
    from sherman_tpu_torch import config as C
    from sherman_tpu_torch.ops import page_kernels as PK
    rng = np.random.default_rng(0)

    def rw(shape):
        return torch.from_numpy(rng.integers(
            -2**31, 2**31, shape, dtype=np.int64).astype(np.int32)).to(dev)

    for B, P, stop in ((777, 32, 0), (4099, 64, 1), (8, 16, 0),
                       (100_003, 8192, 0), (65_537, 4096, 1)):
        pool = rw((P, C.PAGE_WORDS))
        addr = rw(B)
        k = B // 3   # in-range pages, pages past the pool, garbage words
        addr[:k] = torch.from_numpy(rng.integers(0, P, k).astype(np.int32))
        addr[k:2 * k] = torch.from_numpy(
            rng.integers(0, 2 * P, k).astype(np.int32))
        khi, klo = rw(B), rw(B)
        act = torch.from_numpy(rng.integers(0, 2, B).astype(bool)).to(dev)
        _eq(PK.descent_round(pool, addr, khi, klo, act, stop_level=stop),
            PK.descent_round_ref(pool, addr, khi, klo, act,
                                 stop_level=stop), f"descent_round B={B}")
        _eq(PK.gather_pages(pool, addr), PK.gather_pages_ref(pool, addr),
            f"gather_pages B={B}")
        _eq(PK.read_pages_local(pool, addr, act),
            (PK.gather_pages_ref(pool, addr & C.ADDR_PAGE_MASK,
                                 act & ((addr & C.ADDR_PAGE_MASK) < P)),
             act & ((addr & C.ADDR_PAGE_MASK) < P)),
            f"gather_pages (read_pages_local) B={B}")
        page = torch.from_numpy(rng.integers(0, P, B).astype(np.int32)).to(dev)
        slot = torch.from_numpy(
            rng.integers(0, C.LEAF_CAP, B).astype(np.int32)).to(dev)
        applied = _unique_targets(page, slot) & \
            torch.from_numpy(rng.integers(0, 2, B).astype(bool)).to(dev)
        # applied also as a view 5 bytes into its buffer (not 16-aligned)
        shifted = torch.zeros(B + 5, dtype=torch.bool, device=dev)
        shifted[5:] = applied
        for lanes in ((C.L_VER_W, C.L_VHI_W, C.L_VLO_W),
                      (C.L_VER_W, C.L_KHI_W, C.L_KLO_W, C.L_VHI_W,
                       C.L_VLO_W)):
            ent = rw((B, len(lanes)))
            want = PK.writeback_ref(pool.clone(), page, slot, applied, ent,
                                    lanes)
            for app in (applied, shifted[5:]):
                _eq(PK.writeback(pool.clone(), page, slot, app, ent, lanes),
                    want, f"writeback B={B} L={len(lanes)} "
                          f"applied at +{app.data_ptr() % 16} B")
        # the delete's one-lane clear: rows share targets, each target's
        # rows carrying one value (a hash of the target)
        dup = torch.from_numpy(rng.integers(0, max(1, B // 4), B)).to(dev)
        tgt = page[dup].long() * 64 + slot[dup].long()
        ent = ((tgt * 0x9E3779B1) & 0xFFFFFFFF).to(torch.int32)[:, None]
        lane = (C.L_VER_W,)
        _eq(PK.writeback(pool.clone(), page[dup], slot[dup], applied, ent,
                         lane),
            PK.writeback_ref(pool.clone(), page[dup], slot[dup], applied,
                             ent, lane),
            f"writeback B={B} L=1 duplicate targets with equal values")
    torch.cuda.synchronize()


def exchange_parity(dev) -> None:
    """K4 against its plain version on garbage: vector and word copy
    widths (C*W % 4 == 0 and != 0), a round-1 page-reply width (W = 257),
    and bool / float32 fields through the packer."""
    from sherman_tpu_torch.parallel import transport as T
    from sherman_tpu_torch.parallel import transport_kernel as TK
    rng = np.random.default_rng(1)

    def rw(shape):
        return torch.from_numpy(rng.integers(
            -2**31, 2**31, shape, dtype=np.int64).astype(np.int32))

    for n, c, w in ((8, 4, 1), (4, 8, 16), (8, 1024, 257), (3, 5, 3),
                    (8, 333, 1)):
        x = rw((n, n * c, w))
        _eq(TK.all_to_all(x.to(dev)).cpu(), TK.all_to_all_ref(x),
            f"exchange N={n} C={c} W={w}")
    n, c = 8, 64
    tree = {"data": rw((n, n * c, 256)),
            "ok": torch.from_numpy(rng.integers(0, 2, (n, n * c))
                                   .astype(bool)),
            "f": rw((n, n * c)).view(torch.float32)}
    got = T.exchange({k: v.to(dev) for k, v in tree.items()})
    want = T.exchange(tree)
    words = lambda t: (t.to(torch.int32) if t.dtype == torch.bool
                       else t.view(torch.int32))        # bit patterns
    for k in tree:
        if got[k].dtype != want[k].dtype:
            raise AssertionError(f"exchange packer changed {k}'s dtype")
        _eq(words(got[k].cpu()), words(want[k]),
            f"exchange packer field {k}")
    torch.cuda.synchronize()


def _unique_targets(page: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """Mask keeping the first row of every (page, slot) target.  The
    write-back contract lets applied rows share a word only when they
    carry equal values there (the delete's one-lane clear); garbage
    entries differ, so these rows keep one row a target."""
    key = page.long() * 64 + slot.long()
    _, inv = torch.unique(key, return_inverse=True)
    first = torch.full((int(inv.max()) + 1,), key.numel(), device=key.device)
    first = first.scatter_reduce(0, inv, torch.arange(key.numel(),
                                                      device=key.device),
                                 "amin")
    keep = torch.zeros(key.numel(), dtype=torch.bool, device=key.device)
    keep[first] = True
    return keep


# ---------------------------------------------------------------------------
# Phases 2-4: the serving path.
# ---------------------------------------------------------------------------

def serve(n_keys: int, batch_c: int, batch_a: int, steps: int,
          device: str, seed: int = 7, log=_log, machine_nr: int = 1,
          step_capacity: int | None = None, chunk_pages: int = 4096) -> dict:
    """Build, load and serve one tree; ``batch_c``/``batch_a`` are the
    whole batches, split into ``machine_nr`` node blocks."""
    from sherman_tpu_torch.bench import build
    from sherman_tpu_torch.models import batched
    from sherman_tpu_torch.workload.zipf import ZipfGen

    b = build(n_keys, batch_c, batch_a, device, log=log,
              machine_nr=machine_nr, step_capacity=step_capacity,
              chunk_pages=chunk_pages)
    cluster, tree, eng_c, eng_a = b["cluster"], b["tree"], b["eng_c"], \
        b["eng_a"]
    salt, vals, N = b["salt"], b["vals"], machine_nr

    rng = np.random.default_rng(seed)
    zipf = ZipfGen(n_keys, 0.99, seed=seed)      # the native sampler

    # -- YCSB-C: combined point lookups --------------------------------------
    walls = []
    for s in range(steps + 1):
        q = keys_of(zipf.sample(batch_c), salt)
        t = time.perf_counter()
        v, f = eng_c.search_combined(q)
        dt = time.perf_counter() - t
        if not (f.all() and np.array_equal(v, q ^ VAL_XOR)):
            raise AssertionError(f"YCSB-C step {s}: {int((~f).sum())} "
                                 "missing or wrong answers")
        if s:                              # step 0 is the warm-up
            walls.append(dt)
    absent = keys_of(np.arange(n_keys, n_keys + 65_536, dtype=np.uint64),
                     salt)
    _, f_abs = eng_c.search_combined(absent)
    if f_abs.any():
        raise AssertionError(f"{int(f_abs.sum())} absent keys found")
    ops_c = steps * batch_c / sum(walls)
    log(f"ycsb_c: batch={batch_c} steps={steps} ops_per_s={ops_c:.0f} "
         f"step_wall_ms={[round(w * 1e3, 3) for w in walls]}")

    # -- YCSB-A: 50/50 read/update through the fused mixed step -------------
    cur = vals.copy()                      # current value by rank
    walls_a = []
    upd_ranks = []
    for s in range(steps + 1):
        ranks = zipf.sample(batch_a)
        q = keys_of(ranks, salt)
        is_read = rng.random(batch_a) < 0.5
        step_salt = np.uint64((0x9E3779B97F4A7C15 * (s + 1)) & (2**64 - 1))
        wv = q ^ step_salt
        t = time.perf_counter()
        out, found, st = eng_a.mixed(q, wv, is_read)
        dt = time.perf_counter() - t
        w = ~is_read
        if not np.isin(st[w], (batched.ST_APPLIED,
                               batched.ST_SUPERSEDED)).all():
            raise AssertionError(f"YCSB-A step {s}: write statuses "
                                 f"{np.bincount(st[w])}")
        if int((st[w] == batched.ST_APPLIED).sum()) != np.unique(q[w]).size:
            raise AssertionError(f"YCSB-A step {s}: not one applied write "
                                 "per written key")
        written = np.zeros(batch_a, bool)
        written[is_read] = np.isin(ranks[is_read], ranks[w])
        r_ok = found[is_read] & (
            (out[is_read] == cur[ranks[is_read]])
            | (written[is_read] & (out[is_read] == wv[is_read])))
        if not r_ok.all():
            raise AssertionError(f"YCSB-A step {s}: {int((~r_ok).sum())} "
                                 "reads outside the step rule")
        cur[ranks[w]] = wv[w]
        upd_ranks.append(ranks[w])
        if s:
            walls_a.append(dt)
    ur = np.unique(np.concatenate(upd_ranks))
    for i in range(0, ur.size, batch_c):
        r = ur[i:i + batch_c]
        v, f = eng_c.search_combined(keys_of(r, salt))
        if not (f.all() and np.array_equal(v, cur[r])):
            raise AssertionError("YCSB-A: an updated key does not read "
                                 "back its last written value")
    ops_a = steps * batch_a / sum(walls_a)
    log(f"ycsb_a: batch={batch_a} steps={steps} ops_per_s={ops_a:.0f} "
         f"updated_keys_verified={ur.size} "
         f"step_wall_ms={[round(w * 1e3, 3) for w in walls_a]}")
    log(f"counters: {cluster.dsm.counter_snapshot()}")
    if N > 1:
        log("counters_per_node: " + json.dumps(
            cluster.dsm.counters_np().reshape(N, -1).tolist()))
    return {"tree": tree, "eng_c": eng_c, "eng_a": eng_a, "zipf": zipf,
            "salt": salt, "ops_c": ops_c, "ops_a": ops_a, "n_keys": n_keys,
            "updated_ranks": ur}


def reference_check(**kw) -> None:
    """The whole path at a small size on the card and on the CPU (where
    every wrapper runs its plain version) from the same seed: the pools,
    locks and counters must come out bit-identical."""
    ctx = {d: serve(20_000, 2048, 1024, 2, d, log=lambda m: None, **kw)
           for d in ("cuda", "cpu")}
    a, b = (ctx[d]["tree"].dsm for d in ("cuda", "cpu"))
    if not (torch.equal(a.pool.cpu(), b.pool)
            and torch.equal(a.locks.cpu(), b.locks)
            and torch.equal(a.counters.cpu(), b.counters)):
        raise AssertionError(f"the path on the card ({kw}) disagrees "
                             "with its plain version on the CPU")


def profile_step(name: str, fn) -> None:
    """One step under torch.profiler: wall time, the device's busy time
    (kernels and copies) and the largest device items."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    _log(f"profile_{name}: wall_ms={wall * 1e3:.3f} "
         + (f"device_busy_ms={busy:.3f} idle_share={1 - busy / (wall * 1e3):.4f} "
            f"top_device_ms={[(k[:60], round(v, 3)) for k, v in top]}"
            if busy > 0 else "device_busy_ms=not measured"))


def host_breakdown(ctx: dict, batch_c: int) -> None:
    """Host-side pieces of one YCSB-C step, timed alone: the request
    combining (np.unique) and the router probe."""
    from sherman_tpu_torch.ops import bits
    eng = ctx["eng_c"]
    q = keys_of(ctx["zipf"].sample(batch_c), ctx["salt"])
    t = time.perf_counter()
    uk = np.unique(q, return_inverse=True)[0]
    t_unique = time.perf_counter() - t
    khi, klo = bits.keys_to_pairs(uk)
    khi, klo = eng._pad(khi), eng._pad(klo)
    t = time.perf_counter()
    eng.router.host_start(khi, klo)
    t_route = time.perf_counter() - t
    _log(f"host_breakdown_c: unique_keys={uk.size} "
         f"np_unique_ms={t_unique * 1e3:.3f} "
         f"router_probe_ms={t_route * 1e3:.3f}")


# ---------------------------------------------------------------------------
# Launches by shape, and the kernels replayed at every shape a path gave them.
# ---------------------------------------------------------------------------

PAGE_SRC = "sherman_tpu_torch/ops/csrc/page_kernels.cu"
KERNELS = {   # name -> (TPU kernel it replaces, source of the CUDA kernel)
    "descent_round": ("sherman_tpu/ops/pallas_page.py:282", PAGE_SRC),
    "gather_pages": ("sherman_tpu/ops/pallas_page.py:471", PAGE_SRC),
    "writeback": ("sherman_tpu/ops/pallas_page.py:385", PAGE_SRC),
    "exchange": ("sherman_tpu/parallel/transport_pallas.py:147",
                 "sherman_tpu_torch/parallel/csrc/exchange.cu"),
}


def _shape(kernel: str, args, kw) -> tuple:
    """The input shape by which a kernel's launches are told apart (K4's
    rank layout, ``block_transpose``: ``("layout", a, b, run)``)."""
    if kernel == "exchange":
        if len(args) >= 3:
            a, b = int(args[1]), int(args[2])
            return ("layout", a, b, args[0].numel() // (a * b))
        return tuple(args[0].shape)
    pool, rows = args[0], args[1]
    if kernel == "descent_round":
        return (pool.shape[0], rows.shape[0], kw.get("stop_level", 0))
    if kernel == "gather_pages":
        ok = args[2] if len(args) > 2 else kw.get("ok")
        return (pool.shape[0], rows.shape[0], ok is not None)
    return (pool.shape[0], rows.shape[0], len(args[5]))      # lanes


class ShapeLog:
    """While open, counts the launches a window makes through each kernel
    wrapper, by input shape, and keeps the arguments of each shape's first
    launch for replay (K1-K3; K3: of its first launch with an applied row,
    since an empty mask does no work; K4's buffers, up to 8.6 GB each, are
    not kept: its work does not depend on the data).  While ``site`` is
    set, K2's launches are told apart under it too (the scan prefetch).
    The spies only count on the host.  Opening resets the wrappers' launch
    counts;
    :meth:`check` holds the spies' counts to those, so a caller that
    reached a kernel around its module attribute fails the run instead
    of going uncounted."""

    device_type = "cuda"
    site: str | None = None

    def __enter__(self):
        from sherman_tpu_torch.ops import page_kernels as PK
        from sherman_tpu_torch.parallel import transport_kernel as TK
        self.counts: dict[str, dict[tuple, int]] = {}
        self.args: dict[str, dict[tuple, tuple]] = {}
        self._lock = threading.Lock()   # several threads launch (26b-c)
        self._idle: set = set()      # K3 shapes kept with an empty mask
        # K4 has two wrappers: the one-rank exchange and the rank layout
        self._orig = [(m, a, getattr(m, a), k) for m, a, k in (
            (PK, "descent_round", "descent_round"),
            (PK, "gather_pages", "gather_pages"),
            (PK, "writeback", "writeback"), (TK, "all_to_all", "exchange"),
            (TK, "block_transpose", "exchange"))]
        for mod, attr, fn, kernel in self._orig:
            setattr(mod, attr, self._spy(kernel, fn))
        PK.reset_launches()
        TK.reset_launches()
        return self

    def _spy(self, kernel: str, fn):
        def spy(*args, **kw):
            out = fn(*args, **kw)
            if args[0].device.type != self.device_type:
                return out
            with self._lock:
                shape = _shape(kernel, args, kw)
                if kernel == "gather_pages" and self.site:
                    shape += (self.site,)
                by = self.counts.setdefault(kernel, {})
                by[shape] = by.get(shape, 0) + 1
                kept = self.args.setdefault(kernel, {})
                if kernel == "writeback" and shape in kept \
                        and shape in self._idle:
                    # replace a kept launch that applied no row (one host
                    # sync a launch until a shape has one that does)
                    if bool(args[3].any()):
                        kept[shape] = (args, kw)
                        self._idle.discard(shape)
                elif kernel != "exchange" and shape not in kept:
                    kept[shape] = (args, kw)
                    if kernel == "writeback" and not bool(args[3].any()):
                        self._idle.add(shape)
            return out
        return spy

    def __exit__(self, *exc) -> bool:
        from sherman_tpu_torch.ops import page_kernels as PK
        from sherman_tpu_torch.parallel import transport_kernel as TK
        for mod, attr, fn, _ in self._orig:
            setattr(mod, attr, fn)
        self.launches = {**PK.LAUNCHES, **TK.LAUNCHES}
        return False

    def check(self, path: str, must_launch) -> None:
        counted = {k: sum(self.counts.get(k, {}).values())
                   for k in self.launches}
        if counted != self.launches:
            raise AssertionError(f"{path}: launches seen by shape "
                                 f"{counted} != the wrappers' counts "
                                 f"{self.launches}")
        missing = [k for k in must_launch if self.launches[k] == 0]
        if missing:
            raise AssertionError(f"kernels not launched on the {path} "
                                 f"path: {missing}")
        _log(f"{path} launches: {self.launches}; by shape: " + json.dumps(
            {k: [[list(s), n] for s, n in v.items()]
             for k, v in self.counts.items()}))


def replay_descent_round(pool, addr, khi, klo, active, *, stop_level=0):
    """K1 against its plain version, then timed in turns with the earlier
    design (``ms_before``) on the same inputs, and the earlier design's
    two ablations: every row inactive, and the page fetch without the
    search."""
    from sherman_tpu_torch import config as C
    from sherman_tpu_torch.ops import bits
    from sherman_tpu_torch.ops import page_kernels as PK
    args, kw = (pool, addr, khi, klo, active), {"stop_level": stop_level}
    B = addr.shape[0]
    out = PK.descent_round(*args, **kw)
    want = PK.descent_round_ref(*args, **kw)
    _eq(out, want, f"descent_round B={B} P={pool.shape[0]}")
    if not all(torch.equal(x, y) for x, y in
               zip(BASELINE.descent_round(*args, **kw), want)):
        raise AssertionError(f"the earlier descent_round disagrees at B={B}")
    n_act = int(active.sum())
    # each input read once: the mask, addr/khi/klo of the active rows, every
    # distinct page the ok rows need (zipf batches share leaves); the seven
    # outputs
    pages = int(torch.unique(bits.addr_page(addr)[out[3]]).numel())
    del out, want
    nbytes = B * 1 + n_act * 3 * 4 + B * (3 * 4 + 4) + pages * C.PAGE_BYTES
    # per active row: ~6 operations on each of the 82 entry and 49 slot
    # words searched
    nops = n_act * 6 * (C.INTERNAL_CAP + C.LEAF_CAP)
    ms, ms_before = time_ab(lambda: PK.descent_round(*args, **kw),
                            lambda: BASELINE.descent_round(*args, **kw))
    none = torch.zeros_like(active)
    return {"rows": B, "pool_pages": pool.shape[0], "stop_level": stop_level,
            "active_rows": n_act, "distinct_pages": pages,
            "ms": ms, "ms_before": ms_before,
            "host_ms": host_ms(lambda: PK.descent_round(*args, **kw)),
            "ablation_inactive_ms": time_ms(lambda: BASELINE.descent_round(
                pool, addr, khi, klo, none, **kw)),
            "ablation_fetch_only_ms": time_ms(lambda: BASELINE.descent_round(
                *args, **kw, mode=1)),
            "plain_ms": time_ms(lambda: PK.descent_round_ref(*args, **kw),
                                reps=5),
            "library_ms": None, **bound(nbytes, nops)}


def replay_gather_pages(pool, rows, ok=None):
    from sherman_tpu_torch import config as C
    from sherman_tpu_torch.ops import page_kernels as PK
    M, P = rows.shape[0], pool.shape[0]
    _eq(PK.gather_pages(pool, rows, ok), PK.gather_pages_ref(pool, rows, ok),
        f"gather_pages M={M} P={P} ok={ok is not None}")
    src = rows.clamp(0, P - 1)
    # rows (and ok) in, every distinct source page read once, [M, 256] out
    pages = int(torch.unique(src if ok is None else src[ok]).numel())
    nbytes = M * 4 + (0 if ok is None else M) + (pages + M) * C.PAGE_BYTES
    lib = None
    if ok is None:     # the library's row gather (the rows are in range)
        src_l = src.long()
        lib = time_ms(lambda: pool.index_select(0, src_l), reps=5)
    return {"rows": M, "pool_pages": P, "ok": ok is not None,
            "distinct_pages": pages,
            "ms": time_ms(lambda: PK.gather_pages(pool, rows, ok)),
            "plain_ms": time_ms(lambda: PK.gather_pages_ref(pool, rows, ok),
                                reps=5),
            "library_ms": lib, **bound(nbytes, 0)}


def replay_writeback(pool, page, slot, applied, ent, field_w):
    """Parity on clones with fresh values; timing in place with the words
    the targets hold now, so the pool is left as it is.  The kernel is
    timed in turns with the earlier design (``ms_before``); the library
    call is handed the compacted indices."""
    from sherman_tpu_torch import config as C
    from sherman_tpu_torch.ops import page_kernels as PK
    M, L = page.shape[0], len(field_w)
    fw = torch.tensor(list(field_w), device=pool.device)
    idx = (page.long() * C.PAGE_WORDS)[:, None] + fw[None, :] \
        + slot.long()[:, None]
    flat = pool.view(-1)
    ent_same = flat[idx].contiguous()
    ent_new = ent ^ 0x5A5A5A5A
    wb_args = (page, slot, applied, ent_new, field_w)
    want = PK.writeback_ref(pool.clone(), *wb_args)
    _eq(PK.writeback(pool.clone(), *wb_args), want,
        f"writeback M={M} P={pool.shape[0]} L={L}")
    if not torch.equal(BASELINE.writeback(pool.clone(), *wb_args), want):
        raise AssertionError(f"the earlier writeback disagrees at M={M}")
    del want
    n_app = int(applied.sum())
    sel = applied[:, None].expand_as(idx)
    flat_idx, flat_val = idx[sel], ent_same[sel]
    # the mask; per applied row its page, slot and L entries read and L
    # words written
    nbytes = M + n_app * (4 + 4 + 8 * L)
    same = (page, slot, applied, ent_same, field_w)
    ms, ms_before = time_ab(lambda: PK.writeback(pool, *same),
                            lambda: BASELINE.writeback(pool, *same))
    empty = (page, slot, torch.zeros_like(applied), ent_same, field_w)
    return {"rows": M, "pool_pages": pool.shape[0], "lanes": L,
            "applied_rows": n_app, "ms": ms, "ms_before": ms_before,
            "host_ms": host_ms(lambda: PK.writeback(pool, *same)),
            "ablation_empty_mask_ms": time_ms(
                lambda: PK.writeback(pool, *empty)),
            "plain_ms": time_ms(lambda: PK.writeback_ref(pool, *same),
                                reps=5),
            "library_ms": time_ms(
                lambda: flat.index_put_((flat_idx,), flat_val)),
            **bound(nbytes, 0)}


def replay_exchange(x: torch.Tensor, data: str) -> dict:
    """K4 against its plain version on ``x``, then timed beside it,
    ``transpose(0, 1).contiguous()`` and its bound."""
    from sherman_tpu_torch.parallel import transport_kernel as TK
    N, NC, W = x.shape
    _eq(TK.all_to_all(x), TK.all_to_all_ref(x),
        f"exchange {data} [{N}, {NC}, {W}]")
    lib = lambda: x.view(N, N, NC // N, W).transpose(0, 1).contiguous()
    return {"shape": [N, NC, W], "data": data,
            "ms": time_ms(lambda: TK.all_to_all(x)),
            "plain_ms": time_ms(lambda: TK.all_to_all_ref(x), reps=5),
            "library_ms": time_ms(lib, reps=5),
            # each word read once and written once
            **bound(2 * x.numel() * 4, 0)}


def replay_exchange_layout(a: int, b: int, run: int, gen, dev) -> dict:
    """K4 in its rank layout (the block transpose of an ``[a, b]`` grid of
    ``run``-word runs, one of the two launches around a cross-rank
    collective) against its plain version on random words, then timed
    beside it, ``transpose(0, 1).contiguous()`` and its bound."""
    from sherman_tpu_torch.parallel import transport_kernel as TK
    x = torch.randint(-2**31, 2**31 - 1, (a * b * run,), generator=gen,
                      dtype=torch.int32, device=dev)
    _eq(TK.block_transpose(x, a, b), TK.block_transpose_ref(x, a, b),
        f"exchange layout [{a}, {b}, {run}]")
    lib = lambda: x.view(a, b, run).transpose(0, 1).contiguous()
    return {"shape": ["layout", a, b, run], "data": "random",
            "ms": time_ms(lambda: TK.block_transpose(x, a, b)),
            "plain_ms": time_ms(lambda: TK.block_transpose_ref(x, a, b),
                                reps=5),
            "library_ms": time_ms(lib, reps=5),
            **bound(2 * x.numel() * 4, 0)}


REPLAY = {"descent_round": replay_descent_round,
          "gather_pages": replay_gather_pages, "writeback": replay_writeback}


def replay(log: ShapeLog, path: str, real=None) -> dict:
    """Every (kernel, shape) the window launched, held against its plain
    version and timed on the window's own inputs (K4: on a buffer
    captured from the path where ``real`` has one of that shape, else on
    random words of the shape; each buffer of ``real`` must be of a
    launched shape) -> {kernel: [per-shape entries]}."""
    dev = torch.device(log.device_type)
    gen = torch.Generator(device=dev).manual_seed(4)
    real = {} if real is None else real
    out: dict[str, list] = {}
    for kernel, by_shape in log.counts.items():
        for shape, n in by_shape.items():
            if kernel == "exchange" and shape[0] == "layout":
                r = replay_exchange_layout(*shape[1:], gen, dev)
            elif kernel == "exchange":
                x = real.pop(shape, None)
                data = "captured"
                if x is None:
                    x = torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                                      dtype=torch.int32, device=dev)
                    data = "random"
                r = replay_exchange(x, data)
                del x
            else:
                args, kw = log.args[kernel][shape]
                r = REPLAY[kernel](*args, **kw)
                if len(shape) > 3 and kernel == "gather_pages":
                    r["site"] = shape[3]
            out.setdefault(kernel, []).append(
                {"path": path, "launches": n, **r})
    if real:
        raise AssertionError(f"exchanges of shapes {list(real)} were "
                             f"captured but not launched in the window")
    log.args.clear()
    torch.cuda.synchronize()
    return out


PATHS = ("one_node", "one_node_staged", "eight_nodes", "eight_nodes_staged",
         "one_node_storm", "eight_nodes_storm", "one_node_churn",
         "one_node_ycsb", "eight_nodes_ycsb", "one_node_integrity",
         "one_node_durability", "one_node_obs", "one_node_cache",
         "one_node_heap", "one_node_serve", "one_node_crash",
         "one_node_failover", "one_node_partition", "one_node_reshard",
         "two_node_contract", "two_host_multihost",
         "two_host_hostfail", "one_node_native", "1t", "8t", "2r", "2c")


def kernel_record(name: str, shapes: list[dict]) -> dict:
    """One kernel's line: its launches over both paths; ``ms``,
    ``plain_ms``, ``library_ms`` and ``bound_ms`` are means per launch
    over the shapes it was launched at (so ``launches * (ms - bound_ms)``
    sums over the shapes), and ``shapes`` has each one.  Where the library
    call computes the kernel's function at only some shapes,
    ``library_shapes`` gives both means per launch over those shapes."""
    n = sum(s["launches"] for s in shapes)
    mean = lambda k: sum(s["launches"] * s[k] for s in shapes) / n
    lib = [s for s in shapes if s["library_ms"] is not None]
    n_lib = sum(s["launches"] for s in lib)
    by_path = {p: sum(s["launches"] for s in shapes if s["path"] == p)
               for p in PATHS}
    rep, src = KERNELS[name]
    return {"name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": n, "max_abs_err": MAX_ERR[name], "ms": mean("ms"),
            "plain_ms": mean("plain_ms"), "bound_ms": mean("bound_ms"),
            "bound_by": max(shapes, key=lambda s: s["launches"]
                            * s["bound_ms"])["bound_by"],
            "library_ms": (mean("library_ms") if all(
                s["library_ms"] is not None for s in shapes) else None),
            "ms_before": (mean("ms_before") if all(
                "ms_before" in s for s in shapes) else None),
            "library_shapes": {
                "shapes": len(lib), "of": len(shapes), "launches": n_lib,
                "ms": (sum(s["launches"] * s["ms"] for s in lib) / n_lib
                       if n_lib else None),
                "library_ms": (sum(s["launches"] * s["library_ms"]
                                   for s in lib) / n_lib if n_lib else None)},
            "bytes": round(mean("bytes")), "launches_by_path": by_path,
            "shapes": shapes}


def real_page_parity(ctx: dict, batch_c: int) -> None:
    """K1 from the root to level 1 and K2 with its ``ok`` mask (the
    single-node ``read_pages`` contract) on this pool's real pages, two
    variants the serving steps do not launch."""
    from sherman_tpu_torch.ops import bits
    from sherman_tpu_torch.ops import page_kernels as PK
    tree, eng = ctx["tree"], ctx["eng_c"]
    pool = tree.dsm.pool
    T = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(pool.device)
    uk = np.unique(keys_of(ctx["zipf"].sample(batch_c), ctx["salt"]))
    khi, klo = bits.keys_to_pairs(uk)
    khi, klo = eng._pad(khi), eng._pad(klo)
    act = T(eng._pad(np.ones(uk.size, bool)))
    start = T(eng.router.host_start(khi, klo))
    khi_t, klo_t = T(khi), T(klo)
    root = torch.full_like(start, tree._root_addr)
    _eq(PK.descent_round(pool, root, khi_t, klo_t, act, stop_level=1),
        PK.descent_round_ref(pool, root, khi_t, klo_t, act, stop_level=1),
        "descent_round real pages stop_level=1")
    rows = bits.addr_page(start).contiguous()
    ok = act & (rows < pool.shape[0])
    _eq(PK.gather_pages(pool, rows, ok), PK.gather_pages_ref(pool, rows, ok),
        "gather_pages (read_pages_local) real pages")
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# Phases 6-7: the 8-node path.
# ---------------------------------------------------------------------------

def count_overflow():
    """Count, per bucket capacity, the active rows that found no slot in
    their destination bucket.  -> (counts, restore); ``counts`` stays
    empty if no bucketize was reached."""
    from sherman_tpu_torch.parallel import transport as T
    orig = T.bucketize
    counts: dict[int, torch.Tensor] = {}

    def counted(dest, active, n_nodes, capacity):
        bucket_idx, routed = orig(dest, active, n_nodes, capacity)
        n = (active & ~routed).sum()
        counts[capacity] = counts.get(capacity, 0) + n
        return bucket_idx, routed

    T.bucketize = counted
    return counts, lambda: setattr(T, "bucketize", orig)


def capture_exchange(fn, width: int) -> torch.Tensor:
    """The first packed ``[N, N*C, width]`` buffer that ``fn`` hands the
    exchange kernel."""
    from sherman_tpu_torch.parallel import transport_kernel as TK
    orig = TK.all_to_all
    got = []

    def record(x):
        if x.shape[2] == width and not got:
            got.append(x)
        return orig(x)

    TK.all_to_all = record
    try:
        fn()
    finally:
        TK.all_to_all = orig
    if not got:
        raise AssertionError(f"no exchange of width {width} in the step")
    return got[0]


def multinode(n_keys, batch_c, batch_a, steps) -> dict:
    """Phases 6-7 -> {kernel: [per-shape entries of the 8-node window]}."""
    N, cap = 8, 131_072
    torch.cuda.reset_peak_memory_stats()
    with ShapeLog() as log:
        ctx = serve(n_keys, batch_c, batch_a, steps, "cuda", machine_nr=N,
                    step_capacity=cap)
    _log(f"8-node peak device memory: "
         f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    log.check("8-node", ("gather_pages", "writeback", "exchange"))

    # untimed probe steps of each kind at the window's batch sizes: bucket
    # overflow, and the round-1 page reply and write request exchanged
    zipf, salt = ctx["zipf"], ctx["salt"]
    qc = keys_of(zipf.sample(batch_c), salt)
    qa = keys_of(zipf.sample(batch_a), salt)
    ra = np.random.default_rng(6).random(batch_a) < 0.5
    overflow, restore = count_overflow()
    try:
        reply = capture_exchange(lambda: ctx["eng_c"].search_combined(qc),
                                 257)
        request = capture_exchange(
            lambda: ctx["eng_a"].mixed(qa, qa ^ VAL_XOR, ra), 6)
    finally:
        restore()
    if not overflow:
        raise AssertionError("the overflow count reached no bucketize")
    _log("8-node bucket overflow in one untimed step of each kind "
         "(unrouted active rows, by capacity): "
         + json.dumps({k: int(v) for k, v in overflow.items()}))
    real = {tuple(reply.shape): reply, tuple(request.shape): request}
    del reply, request       # replay frees each buffer once it is used
    shapes = replay(log, "eight_nodes", real)
    _log("8-node parity at every launched shape (K2, K3, K4 on captured "
         "and random buffers): exact")
    profile_step("ycsb_c_8_nodes", lambda: ctx["eng_c"].search_combined(qc))
    profile_step("ycsb_a_8_nodes",
                 lambda: ctx["eng_a"].mixed(qa, qa ^ VAL_XOR, ra))
    del real, qc, qa
    for k, v in staged_windows(ctx, "eight_nodes", batch_c // N,
                               batch_a // N, STAGED_STEPS_8,
                               ("gather_pages", "writeback",
                                "exchange")).items():
        shapes.setdefault(k, []).extend(v)
    return shapes


# ---------------------------------------------------------------------------
# The device-staged loops (prep -> serve -> verify on the card).
# ---------------------------------------------------------------------------

def count_syncs(fn) -> int:
    """Host syncs that ``fn`` makes (item(), nonzero, device-to-host
    copies), as torch's sync debug mode reports them."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in seen)


def _ints(carry) -> list:
    return [int(x) for x in carry]


def staged_read(eng, n_keys, salt, batch, dev_b, staged, fusion, steps,
                sampler="analytic") -> tuple[dict, object]:
    """``bench.staged_read`` (3 synced steps), then the host syncs of
    one step; the step gets ``replay`` (one fresh-carry step) and
    ``profile`` (its phase times).  -> (record, step)."""
    from sherman_tpu_torch import bench
    rec, step, new_carry = bench.staged_read(
        eng, n_keys, 0.99, salt, batch, dev_b, staged, sampler=sampler,
        fusion=fusion, steps=steps, lat_steps=3)
    pool, counters = eng.dsm.pool, eng.dsm.counters
    box = {"carry": new_carry()}     # made outside the counted step

    def one():
        box["carry"] = step(pool, counters, *staged, box["carry"])[1]

    rec["host_syncs_per_step"] = count_syncs(one)
    step.drain(box["carry"])
    step.replay = lambda: step.drain(step(pool, counters, *staged,
                                          new_carry())[1])
    step.profile = lambda: step.phase_profile(pool, counters, *staged,
                                              reps=2)[0]
    return rec, step


def staged_mixed(eng, n_keys, salt, batch, carry, caps, staged, fusion,
                 steps, dev_b, sampler="analytic"):
    """``bench.staged_mixed``, then the host syncs of one more step; the
    step gets ``replay`` (one step continuing the carry) and ``profile``
    (its phase times).  -> (record, step, carry, caps, staged)."""
    from sherman_tpu_torch import bench
    rec, step, carry, caps, staged = bench.staged_mixed(
        eng, n_keys, 0.99, salt, batch, sampler=sampler, dev_b=dev_b,
        fusion=fusion, steps=steps, carry=carry, caps=caps, staged=staged)
    pool, locks, counters = eng.dsm.pool, eng.dsm.locks, eng.dsm.counters
    box = {"carry": carry}

    def one():
        box["carry"] = step.drain(step(pool, locks, counters, *staged,
                                       box["carry"])[2])

    rec["host_syncs_per_step"] = count_syncs(one)
    step.replay = one
    step.profile = lambda: step.phase_profile(pool, locks, counters,
                                              *staged, reps=2)[0]
    return rec, step, box["carry"], caps, staged


def prep_breakdown(eng, n_keys: int, salt: int, batch: int, dev_b: int,
                   staged, reps: int = 5) -> dict:
    """Device time of each piece of one staged read prep (the analytic
    sampler), mean of ``reps`` calls between CUDA events: the Threefry
    draws, the rank sampler, the rank->key map, the combining sort and
    the router probe."""
    from sherman_tpu_torch.workload import device_prep as DP
    from sherman_tpu_torch.workload import threefry
    N = eng.cfg.machine_nr
    tb, rt, rk = staged
    gen, _ = DP._rank_sampler("analytic", n_keys, 0.99, 20, rk.device)
    nodes = torch.arange(N, dtype=torch.int64, device=rk.device)
    keys = lambda: threefry.fold_in(rk, nodes)
    w = threefry.bits(keys(), (2, batch)).transpose(0, 1)
    rank = gen(tb, w)
    khi, klo = DP._keys_of_ranks(rank, *DP._words(salt))
    ukhi, uklo = DP._sort_combine(khi, klo, dev_b)[2:4]
    pieces = {
        "threefry": lambda: threefry.bits(keys(), (2, batch)),
        "ranks": lambda: gen(tb, w),
        "mix64": lambda: DP._keys_of_ranks(rank, *DP._words(salt)),
        "sort_combine": lambda: DP._sort_combine(khi, klo, dev_b),
        "router_probe": lambda: DP._router_probe(
            rt, ukhi, uklo, eng.router.shift, eng.router.nb)}
    out = {}
    for name, fn in pieces.items():
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        out[name] = a.elapsed_time(b) / reps
    return out


def restore_bulk_values(ctx: dict) -> None:
    """Write every key the host-staged YCSB-A window updated back to its
    bulk value ``key ^ 0xDEADBEEF``: the staged loops verify every read
    against that value (or a value stamped by a staged write)."""
    from sherman_tpu_torch.models import batched
    eng, ur = ctx["eng_a"], ctx["updated_ranks"]
    for i in range(0, ur.size, eng.total):
        k = keys_of(ur[i:i + eng.total], ctx["salt"])
        _, _, st = eng.mixed(k, k ^ VAL_XOR, np.zeros(k.size, bool))
        if not (st == batched.ST_APPLIED).all():
            raise AssertionError("restoring the bulk values failed")


# each staged loop's ms a step in this run, by (path, loop, fusion)
# (phase 31 prints its steps beside the eight-node aligned YCSB-C one)
STAGED_MS: dict = {}


def staged_windows(ctx: dict, path: str, batch_r: int, batch_m: int,
                   steps: int, must_launch) -> dict:
    """The four staged loops on ``ctx``'s tree — YCSB-C aligned and
    pipelined, then YCSB-A chained and pipelined — inside one launch
    window; then each loop's phase profile and one profiled step, and
    every launched (kernel, shape) replayed.  -> {kernel: [shapes]}."""
    from sherman_tpu_torch.bench import size_dev_b
    eng_c, eng_a = ctx["eng_c"], ctx["eng_a"]
    n_keys, salt = ctx["n_keys"], ctx["salt"]
    restore_bulk_values(ctx)
    recs, steps_of = [], {}
    with ShapeLog() as log:
        dev_b, staged = size_dev_b(eng_c, n_keys, 0.99, salt, batch_r,
                                   "analytic")
        for fusion in ("aligned", "pipelined"):
            rec, st = staged_read(eng_c, n_keys, salt, batch_r, dev_b,
                                  staged, fusion, steps)
            recs.append(rec)
            steps_of[("ycsb_c", fusion)] = st
        carry = caps = staged_m = None
        for fusion in ("chained", "pipelined"):
            rec, st, carry, caps, staged_m = staged_mixed(
                eng_a, n_keys, salt, batch_m, carry, caps, staged_m, fusion,
                steps, dev_b)
            recs.append(rec)
            steps_of[("ycsb_a", fusion)] = st
    log.check(f"{path} staged", must_launch)
    _log(f"staged_prep_breakdown_ms_{path}: " + json.dumps(prep_breakdown(
        eng_c, n_keys, salt, batch_r, dev_b, staged)))
    # after every receipt-checked window: the mixed phase profile
    # re-applies one prepped batch
    for rec in recs:
        st = steps_of[(rec["loop"], rec["fusion"])]
        STAGED_MS[(path, rec["loop"], rec["fusion"])] = rec["ms_per_step"]
        rec["phase_ms"] = st.profile()
        profile_step(f"staged_{rec['loop']}_{rec['fusion']}_{path}",
                     st.replay)
        _log("staged: " + json.dumps(rec))
    shapes = replay(log, path + "_staged")
    _log(f"{path} staged parity at every launched shape: exact")
    return shapes


def staged_reference_check(machine_nr: int,
                           devices=("cuda", "cpu")) -> None:
    """The staged loops at 20,000 keys on the card and on the plain path
    on the CPU from one seed (3 steps of each form, ``sampler="table"``):
    carries, pools, locks and counters bit-identical.  Then the analytic
    sampler: equal receipts, and the count of ranks the card and the CPU
    draw differently (their f32 ``exp``/``log`` round differently)."""
    from sherman_tpu_torch.bench import build
    from sherman_tpu_torch.workload import device_prep as DP
    from sherman_tpu_torch.workload import threefry
    N, n_keys = machine_nr, 20_000
    bc, bm = 2048 if N == 1 else 1024, 1024 if N == 1 else 512
    out = []
    for d in devices:
        b = build(n_keys, bc * N, bm * N, d, log=lambda m: None,
                  machine_nr=N, chunk_pages=64)
        eng_c, eng_a, salt = b["eng_c"], b["eng_a"], b["salt"]
        dsm = eng_c.dsm
        carries = []
        for fusion in ("aligned", "pipelined"):
            step, (nc, tb, rt, rk) = DP.make_staged_step(
                eng_c, n_keys=n_keys, theta=0.99, salt=salt, batch=bc,
                dev_b=bc, log2_bins=16, fusion=fusion)
            c = nc()
            for _ in range(3):
                _, c = step(dsm.pool, dsm.counters, tb, rt, rk, c)
            carries.append(_ints(step.drain(c)))
        c = None
        for fusion in ("chained", "pipelined"):
            step, (nc, tb, rt, rk) = DP.make_staged_mixed_step(
                eng_a, n_keys=n_keys, theta=0.99, salt=salt, batch=bm,
                read_ratio=0.5, dev_rb=bm // 2, dev_wb=bm // 2,
                log2_bins=16, fusion=fusion)
            c = nc() if c is None else c
            for _ in range(3):
                _, _, c = step(dsm.pool, dsm.locks, dsm.counters, tb, rt, rk,
                               c)
            c = step.drain(c)
            carries.append(_ints(c))
        state = [t.cpu() for t in (dsm.pool, dsm.locks, dsm.counters)]
        # the analytic sampler on a fresh tree: the card and the CPU may
        # draw other tail ranks, so its counters are not compared
        b = build(n_keys, bc * N, bm * N, d, log=lambda m: None,
                  machine_nr=N, chunk_pages=64)
        eng, dsm = b["eng_c"], b["eng_c"].dsm
        step, (nc, tb, rt, rk) = DP.make_staged_step(
            eng, n_keys=n_keys, theta=0.99, salt=salt, batch=bc, dev_b=bc,
            sampler="analytic")
        c = nc()
        for _ in range(3):
            _, c = step(dsm.pool, dsm.counters, tb, rt, rk, c)
        analytic = _ints(c)
        ranks = []
        for n in (n_keys, 100_000_000):
            gen, _ = DP._rank_sampler("analytic", n, 0.99, 20, d)
            w = threefry.bits(threefry.PRNGKey(11, device=d), (2, 1 << 20))
            ranks.append(gen(None, w).cpu())
        out.append((carries, analytic, ranks, state))
    (ca, aa, ra, sa), (cb, ab, rb, sb) = out
    if ca != cb or not all(torch.equal(x, y) for x, y in zip(sa, sb)):
        raise AssertionError(f"staged loops ({N} nodes) on the card "
                             f"disagree with the plain path: {ca} vs {cb}")
    for c in ca[:2]:
        if c[1] != 1 or c[2] != 3 * bc * N:
            raise AssertionError(f"staged reference receipts {c}")
    # the mixed forms continue one carry: 3, then 6 steps' reads
    for k, c in ((1, ca[2]), (2, ca[3])):
        if c[1] != 1 or c[2] != 3 * k * bm // 2 * N:
            raise AssertionError(f"staged mixed reference receipts {c}")
    if aa[:3] != ab[:3] or aa[2] != 3 * bc * N:
        raise AssertionError(f"analytic receipts differ: {aa} vs {ab}")
    diffs = [int((x != y).sum()) for x, y in zip(ra, rb)]
    _log(f"staged reference check ({N} node(s), 20,000 keys, card vs plain "
         f"path on the CPU, sampler=table): carries {ca}, pools, locks and "
         f"counters bit-identical; analytic sampler receipts equal "
         f"({aa[:3]}), ranks drawn differently by the card and the CPU: "
         f"{diffs[0]} of {1 << 20} at 20,000 keys, {diffs[1]} of {1 << 20} "
         f"at 100,000,000 keys")

# ---------------------------------------------------------------------------
# The fresh-insert split storm (``tools/insert_bench.py``'s configuration).
# ---------------------------------------------------------------------------

from sherman_tpu_torch import insert_bench as IB  # noqa: E402
from sherman_tpu_torch.insert_bench import (  # noqa: E402
    STORM_XOR, storm_build)
from sherman_tpu_torch.tools_common import verify_all as _verify_all  # noqa


def verify_all(eng, keys: np.ndarray) -> None:
    """Every key found with the value ``key ^ 0xBEEF`` (the storm's and
    the churn's values; ``tools_common.verify_all``)."""
    _verify_all(eng, keys, STORM_XOR)


def storm(ctx: dict, path: str, chunk: int, must_launch,
          reduced: list) -> dict:
    """``insert_bench.storm`` (one warm-up chunk outside the timed window,
    its host syncs counted on the card, then every other fresh key in
    chunks of ``chunk``) inside a launch window; the ``storm`` line; every
    key searched; every launched (kernel, shape) replayed.
    -> {kernel: [shapes]}."""
    log = ShapeLog()
    rec = IB.storm(ctx, chunk, window=log,
                   count_syncs=(count_syncs if ctx["eng"].device.type
                                == "cuda" else None))
    log.check(f"{path} storm", must_launch)
    t = time.perf_counter()
    verify_all(ctx["eng"], ctx["keys"])
    t_verify = time.perf_counter() - t
    _log("storm: " + json.dumps({
        "path": path, **rec, "verified_keys": int(ctx["keys"].size),
        "verify_s": t_verify, "reduced": reduced}))
    return replay(log, path)


def storm_reference_check(machine_nr: int, devices=("cuda", "cpu"),
                          n: int = 20_000) -> None:
    """The storm at ``n`` warm keys (fill 0.9) and ``n`` fresh keys
    (``split_slots`` 256, one ``eng.insert`` call) on the card and on the
    plain path on the CPU from one seed: the stats, pools, locks and
    counters bit-identical, ``Tree.check_structure`` equal and every key
    found on both."""
    N = machine_nr
    out = []
    for d in devices:
        ctx = storm_build(n, n, d, machine_nr=N,
                          batch=2048, split_slots=256, locks_per_node=4096,
                          chunk_pages=64, host_step_capacity=64,
                          log=lambda m: None)
        eng = ctx["eng"]
        st = eng.insert(ctx["fresh"], ctx["fresh"] ^ STORM_XOR)
        structure = ctx["tree"].check_structure()
        verify_all(eng, ctx["keys"])
        out.append((st, structure, [t.cpu() for t in (
            eng.dsm.pool, eng.dsm.locks, eng.dsm.counters)]))
    (sa, ca, xa), (sb, cb, xb) = out
    if sa != sb or ca != cb or not all(torch.equal(x, y)
                                       for x, y in zip(xa, xb)):
        raise AssertionError(f"the storm ({N} nodes) on the card disagrees "
                             f"with the plain path: {sa} {ca} vs {sb} {cb}")
    if sa["host_path"] or ca["keys"] != 2 * n:
        raise AssertionError(f"storm reference: {sa} {ca}")
    _log(f"storm reference check ({N} node(s), {n:,} + {n:,} keys, card "
         f"vs plain path on the CPU): stats {sa}, structure {ca}; pools, "
         f"locks and counters bit-identical")

# ---------------------------------------------------------------------------
# The drifting-keyspace churn (``tools/churn_bench.py``'s configuration):
# delete, empty-leaf reclaim and write combining.
# ---------------------------------------------------------------------------

from sherman_tpu_torch import churn_bench as CB  # noqa: E402
from sherman_tpu_torch.churn_bench import (  # noqa: E402
    churn_build, churn_iteration)


def churn_reference_check(machine_nr: int, devices=("cuda", "cpu"),
                          iters: int = 6) -> None:
    """The churn at 20,000 live keys of 16 streams, 6 iterations of 2,000
    fresh and 2,000 deleted keys and a reclaim pass each, on the card and
    on the plain path on the CPU (8 nodes: step capacity 32, chunk_pages
    64): the insert stats, delete found masks, reclaim stats, free lists,
    reclaim state and router tables after every iteration, and the pools,
    locks and counters at the end, bit-identical; the live slots count
    the live keys exactly and every live key is found."""
    from sherman_tpu_torch.models import batched, validate
    N = machine_nr
    out = []
    for d in devices:
        ctx = churn_build(20_000, 2_000, d, machine_nr=N, chunk=2048,
                          streams=16, locks_per_node=4096, chunk_pages=64,
                          host_step_capacity=64,
                          step_capacity=32 if N > 1 else None,
                          log=lambda m: None)
        eng, tree = ctx["eng"], ctx["tree"]
        rng = np.random.default_rng(23)
        trace = []
        for _ in range(iters):
            r = churn_iteration(ctx, rng)
            trace.append((r["insert"], r["found"].tolist(), r["reclaim"],
                          r["pages_reused"],
                          [x.allocator.free_pages_list
                           for x in tree.cluster.directories],
                          copy.deepcopy(eng._reclaim_state),
                          eng.router.table_np.tolist()))
        live = ctx["key_of"](np.arange(ctx["lo"], ctx["hi"],
                                       dtype=np.uint64))
        # 8 nodes: searched 32 rows a node, which no bucket of 32 rows
        # overflows (a wider batch retried from the root queues at its node)
        veng = eng if N == 1 else batched.BatchedEngine(tree, 32)
        v, f = (np.concatenate(x) for x in zip(*(
            veng.search(live[i:i + veng.total])
            for i in range(0, live.size, veng.total))))
        if not (f.all() and (v == live ^ STORM_XOR).all()):
            raise AssertionError(f"churn reference ({N} nodes, {d}): "
                                 f"{int((~f).sum())} live keys lost")
        n_live = int(validate.leaf_chain_info(tree)[4].sum())
        if n_live != live.size:
            raise AssertionError(f"churn reference ({N} nodes, {d}): "
                                 f"{n_live} live slots for {live.size} keys")
        out.append((trace, [t.cpu() for t in (
            eng.dsm.pool, eng.dsm.locks, eng.dsm.counters)]))
    (ta, xa), (tb, xb) = out
    if ta != tb or not all(torch.equal(x, y) for x, y in zip(xa, xb)):
        raise AssertionError(f"the churn ({N} nodes) on the card disagrees "
                             "with the plain path")
    freed = sum(t[2]["freed"] for t in ta)
    if not freed or not any(t[3] for t in ta):
        raise AssertionError(f"churn reference ({N} nodes): no page freed "
                             f"or reused: {[t[2] for t in ta]}")
    _log(f"churn reference check ({N} node(s), 20,000 live keys, 16 "
         f"streams, {iters} x 2,000, card vs plain path on the CPU): "
         f"reclaim {[t[2] for t in ta]}, pages reused "
         f"{[t[3] for t in ta]}; found masks, stats, free lists, reclaim "
         "state, router tables, pools, locks and counters bit-identical")


def combine_reference_check(machine_nr: int, devices=("cuda", "cpu")) -> None:
    """The storm reference check's inputs with write combining on, on the
    card and on the CPU, beside the card without it: the stats and pools
    of all three equal, the counters of the card's two runs equal but for
    the combine slots, and the combine counters of the card equal to the
    CPU's."""
    from sherman_tpu_torch.parallel import dsm as D
    N = machine_nr
    runs = []
    for d, combine in ((devices[0], False), (devices[0], True),
                       (devices[1], True)):
        ctx = storm_build(20_000, 20_000, d, machine_nr=N,
                          batch=2048, split_slots=256, locks_per_node=4096,
                          chunk_pages=64, host_step_capacity=64,
                          write_combine=combine, log=lambda m: None)
        eng = ctx["eng"]
        st = eng.insert(ctx["fresh"], ctx["fresh"] ^ STORM_XOR)
        runs.append((st, eng.dsm.pool.cpu(), eng.dsm.counters_np().reshape(
            -1, D.N_COUNTERS), eng._combine_steps, eng._combine_rows))
    (s0, p0, c0, _, _), (s1, p1, c1, n1, r1), (s2, p2, c2, n2, r2) = runs
    slots = [D.CNT_COMBINE_GROUPS, D.CNT_COMBINE_SAVED]
    rest = [k for k in range(D.N_COUNTERS) if k not in slots]
    if not (s0 == s1 == s2 and torch.equal(p0, p1) and torch.equal(p1, p2)
            and np.array_equal(c0[:, rest], c1[:, rest])
            and np.array_equal(c1, c2) and (n1, r1) == (n2, r2)
            and not c0[:, slots].any() and c1[:, slots[0]].sum() > 0):
        raise AssertionError(f"write combining ({N} nodes): {s0} {s1} {s2}, "
                             f"combine counters {c1[:, slots].sum(0)} vs "
                             f"{c2[:, slots].sum(0)}")
    _log(f"write-combining reference check ({N} node(s), the storm "
         f"reference inputs): stats and pools equal with combining off and "
         f"on; combine groups/saved {c1[:, slots].sum(0).tolist()} on the "
         "card and the CPU alike")


def churn(ctx: dict, path: str, iters: int, must_launch,
          reduced: list) -> dict:
    """``churn_bench.churn`` (the tool's warm-up outside the timed window,
    its delete's rounds and host syncs counted, then ``iters`` iterations
    with a reclaim pass each) inside a launch window; the ``churn`` line;
    every live key searched, the last deleted window probed, the live
    slots counted (``churn_bench.verify``); every launched (kernel, shape)
    replayed.  -> {kernel: [shapes]}."""
    log = ShapeLog()
    rec = CB.churn(ctx, iters, window=log,
                   count_syncs=(count_syncs if ctx["eng"].device.type
                                == "cuda" else None))
    log.check(f"{path} churn", must_launch)
    if rec["freed"] <= 0 or rec["pages_reused"] <= 0 or rec["host_path"]:
        raise AssertionError(f"{path}: freed {rec['freed']}, pages reused "
                             f"{rec['pages_reused']}, host path "
                             f"{rec['host_path']}")
    t = time.perf_counter()
    tree_keys = CB.verify(ctx)
    t_verify = time.perf_counter() - t
    rec.pop("parked_final")
    _log("churn: " + json.dumps({
        "path": path, **rec, "verified_keys": tree_keys,
        "tree_keys": tree_keys, "verify_s": t_verify, "reduced": reduced}))
    return replay(log, path)


# ---------------------------------------------------------------------------
# The YCSB A-F matrix (``tools/ycsb_bench.py``'s configuration): range scans
# beside the point paths.
# ---------------------------------------------------------------------------

YCSB_OPS = 8192
YCSB_STEPS = 8


class YcsbReplay:
    """A generator that hands out batches drawn beforehand, so the card
    and the CPU play one stream."""

    def __init__(self, batches, gen):
        self.batches = list(batches)
        self.gen = gen

    def batch(self, n):
        return self.batches.pop(0)

    def expectations(self):
        return self.gen.expectations()


class YcsbMirror:
    """The live set of the matrix on the host: the bulk keys (sorted) with
    their values ``key ^ 0xD00D``, A/B's updates (``key ^ 0xBEEF``), the
    D/E inserts (``key ^ 0xD00D``) and F's read-modify-writes (the value
    xor 1, once a key a batch), played batch by batch in order."""

    def __init__(self, keys: np.ndarray):
        self.keys = keys
        self.vals = keys ^ np.uint64(0xD00D)
        self.dead = np.zeros(keys.size, bool)   # deleted bulk keys
        self.fresh: dict[int, int] = {}     # inserted keys outside the bulk

    def _split(self, ks):
        ks = np.unique(ks)
        pos = np.minimum(np.searchsorted(self.keys, ks), self.keys.size - 1)
        bulk = self.keys[pos] == ks
        return pos[bulk], ks[~bulk]

    def play(self, b: dict) -> None:
        if "update" in b:
            pos, new = self._split(b["update"])
            if new.size:
                raise AssertionError("YCSB: an update of an absent key")
            self.vals[pos] = self.keys[pos] ^ np.uint64(0xBEEF)
        if "insert" in b:
            pos, new = self._split(b["insert"])
            self.vals[pos] = self.keys[pos] ^ np.uint64(0xD00D)
            self.fresh.update((int(k), int(k) ^ 0xD00D) for k in new)
        if "rmw" in b:
            pos, new = self._split(b["rmw"])
            self.vals[pos] ^= np.uint64(1)
            for k in new.tolist():
                self.fresh[k] ^= 1

    @property
    def live(self) -> int:
        """Keys in the live set."""
        return int(self.keys.size - self.dead.sum() + len(self.fresh))

    def lookup(self, ks) -> tuple[np.ndarray, np.ndarray]:
        """-> (values uint64, found bool) of ``ks`` in the live set."""
        ks = np.asarray(ks, np.uint64)
        pos = np.minimum(np.searchsorted(self.keys, ks), self.keys.size - 1)
        bulk = self.keys[pos] == ks
        found = bulk & ~self.dead[pos]
        vals = np.where(found, self.vals[pos], np.uint64(0))
        for i in np.nonzero(~bulk)[0]:
            v = self.fresh.get(int(ks[i]))
            if v is not None:
                vals[i], found[i] = v, True
        return vals, found

    def add(self, ks, vs) -> None:
        """Writes of (key, value) pairs, bulk keys or fresh ones."""
        ks, vs = np.asarray(ks, np.uint64), np.asarray(vs, np.uint64)
        pos = np.minimum(np.searchsorted(self.keys, ks), self.keys.size - 1)
        bulk = self.keys[pos] == ks
        self.vals[pos[bulk]] = vs[bulk]
        self.dead[pos[bulk]] = False
        self.fresh.update(zip(ks[~bulk].tolist(), vs[~bulk].tolist()))

    def remove(self, ks) -> None:
        """Deletes of keys of the live set."""
        ks = np.asarray(ks, np.uint64)
        pos = np.minimum(np.searchsorted(self.keys, ks), self.keys.size - 1)
        bulk = self.keys[pos] == ks
        self.dead[pos[bulk]] = True
        for k in ks[~bulk].tolist():
            self.fresh.pop(k, None)

    def check(self, ranges, res) -> int:
        """Every range's (keys, values) against the live set; -> rows."""
        fk = np.array(sorted(self.fresh), np.uint64)
        fv = np.array([self.fresh[k] for k in fk.tolist()], np.uint64)
        lo = np.array([r[0] for r in ranges], np.uint64)
        hi = np.array([r[1] for r in ranges], np.uint64)
        a0, a1 = (np.searchsorted(self.keys, x) for x in (lo, hi))
        b0, b1 = (np.searchsorted(fk, x) for x in (lo, hi))
        rows = 0
        for i, (k, v) in enumerate(res):
            alive = ~self.dead[a0[i]:a1[i]]
            wk = np.concatenate([self.keys[a0[i]:a1[i]][alive],
                                 fk[b0[i]:b1[i]]])
            wv = np.concatenate([self.vals[a0[i]:a1[i]][alive],
                                 fv[b0[i]:b1[i]]])
            order = np.argsort(wk, kind="stable")
            if not (np.array_equal(k, wk[order])
                    and np.array_equal(v, wv[order])):
                raise AssertionError(f"YCSB-E: scan {ranges[i]} returned "
                                     f"{k.size} rows, the live set holds "
                                     f"{wk.size} (or their values differ)")
            rows += k.size
        return rows


def ycsb_batches(n_keys: int, ops: int, steps: int) -> dict:
    """One stream of ``steps`` batches a workload, A-F, from the tool's
    generators (seed 17, the tool's salt)."""
    from sherman_tpu_torch import ycsb_bench as YB
    from sherman_tpu_torch.workload.ycsb import YcsbGen
    out = {}
    for w in "ABCDEF":
        gen = YcsbGen(w, n_keys, theta=0.99, seed=17, salt=YB.SALT)
        out[w] = ([gen.batch(ops) for _ in range(steps)], gen)
    return out


def record_scans(eng) -> list:
    """Every ``range_query_many`` of ``eng`` and its result, in order,
    until the attribute is deleted."""
    seen = []
    scan = eng.range_query_many

    def rec(ranges):
        res = scan(ranges)
        seen.append((ranges, res))
        return res

    eng.range_query_many = rec
    return seen


def ycsb_reference_check(machine_nr: int, devices=("cuda", "cpu"),
                         step_capacity: int | None = None) -> None:
    """``ycsb_bench.build`` at 20,000 keys, then A-F in order, 2,048 ops
    a step, 3 steps each, from one batch stream, on the card and on the
    plain path on the CPU: the rows' counts, every scan's (keys, values),
    the pools, locks and counters bit-identical; every scan equal to the
    host mirror of the live set."""
    from sherman_tpu_torch import ycsb_bench as YB
    N, n_keys, ops, steps = machine_nr, 20_000, 2048, 3
    stream = ycsb_batches(n_keys, ops, steps + 1)
    out = []
    for d in devices:
        _, tree, eng, keys = YB.build(n_keys, ops, N, d,
                                      step_capacity=step_capacity,
                                      log=lambda m: None)
        scans = record_scans(eng)
        counts = {w: YB.run_workload(eng, YcsbReplay(b, g), ops=ops,
                                     steps=steps)["counts"]
                  for w, (b, g) in stream.items()}
        del eng.range_query_many
        out.append((counts, scans, keys, [t.cpu() for t in (
            tree.dsm.pool, tree.dsm.locks, tree.dsm.counters)]))
    (ca, sa, keys, xa), (cb, sb, _, xb) = out
    same = ca == cb and len(sa) == len(sb) and all(
        ra == rb and all(np.array_equal(x, y) for p, q in zip(pa, pb)
                         for x, y in zip(p, q))
        for (ra, pa), (rb, pb) in zip(sa, sb))
    if not same or not all(torch.equal(x, y) for x, y in zip(xa, xb)):
        raise AssertionError(f"the YCSB matrix ({N} nodes) on the card "
                             f"disagrees with the plain path: {ca} vs {cb}")
    mirror, it, rows = YcsbMirror(keys), iter(sa), 0
    for w, (batches, _) in stream.items():
        for b in batches:
            mirror.play(b)
            if "scan" in b:
                ranges, res = next(it)
                rows += mirror.check(ranges, res)
    _log(f"YCSB reference check ({N} node(s), 20,000 keys, A-F x "
         f"{steps + 1} batches of {ops}, card vs plain path on the CPU): "
         f"counts {ca}; {sum(len(r) for r, _ in sa)} scans ({rows} rows) "
         "equal and equal to the host mirror; pools, locks and counters "
         "bit-identical")


class ScanTimers:
    """Wall time of the scans (``range_query_many``) split into the router
    candidates (slices and ``np.unique``), the prefetch (the K2 gather and
    its copy to the host) and the rest, the per-range walk; with the
    prefetch's pages, the chain-gap page reads and the host re-descents
    the walks made.  K2's prefetch launches are told apart in ``log``
    (``site``).  Installed on the module and the tree; :meth:`close`
    removes them; :meth:`reset` zeroes the sums."""

    KEYS = ("scan", "candidates", "prefetch")

    def __init__(self, tree, log: ShapeLog):
        from sherman_tpu_torch.models import batched
        self.mod, self.tree = batched, tree
        self.orig = {a: getattr(batched, a) for a in (
            "range_query_many", "_scan_candidates", "_scan_prefetch")}
        self.reset()
        depth = [0]             # inside a scan: 1; inside its descent: 2

        def timed(key, fn, site=None, nest=0):
            def call(*a, **kw):
                t = time.perf_counter()
                log.site = site
                depth[0] += nest
                try:
                    return fn(*a, **kw)
                finally:
                    depth[0] -= nest
                    log.site = None
                    self.s[key] += time.perf_counter() - t
            return call

        def prefetch(eng, cand):
            self.n["prefetch_pages"] += int(cand.size)
            self.n["prefetches"] += 1
            return pf(eng, cand)

        pf = timed("prefetch", self.orig["_scan_prefetch"], "scan_prefetch")
        batched.range_query_many = timed("scan",
                                         self.orig["range_query_many"],
                                         nest=1)
        batched._scan_candidates = timed("candidates",
                                         self.orig["_scan_candidates"])
        batched._scan_prefetch = prefetch
        read, descend = tree.dsm.read_page, tree._descend

        def counted_descend(*a, **kw):
            self.n["re_descents"] += depth[0] == 1
            depth[0] += 1
            try:
                return descend(*a, **kw)
            finally:
                depth[0] -= 1

        def counted_read(*a, **kw):
            self.n["chain_gap_reads"] += depth[0] == 1
            return read(*a, **kw)

        tree._descend, tree.dsm.read_page = counted_descend, counted_read

    def reset(self) -> None:
        self.s = {k: 0.0 for k in self.KEYS}
        self.n = {"prefetches": 0, "prefetch_pages": 0,
                  "chain_gap_reads": 0, "re_descents": 0}

    def close(self) -> None:
        for a, fn in self.orig.items():
            setattr(self.mod, a, fn)
        del self.tree._descend, self.tree.dsm.read_page

    def split(self) -> dict:
        s = dict(self.s)
        s["walk"] = s["scan"] - s["candidates"] - s["prefetch"]
        return s


def ycsb_matrix(n_keys: int, nodes: int, path: str, must_launch,
                reduced: list, device: str = "cuda") -> tuple[dict, dict]:
    """``tools/ycsb_bench.py``'s configuration (``build``, ``main``'s
    defaults: 8,192 ops a step, theta 0.99, seed 17, one warm-up batch and
    8 timed steps a workload) at ``n_keys`` keys on ``nodes`` nodes: A-F
    in order on one tree inside a launch window; the ``ycsb_matrix``
    line, with E's wall split; every scan of E's timed steps checked
    against the host mirror outside the timed wall; every launched
    (kernel, shape) replayed.  -> ({kernel: [shapes]}, {tree, eng,
    mirror, n_keys}: the tree after A-F and its live set)."""
    from sherman_tpu_torch import ycsb_bench as YB
    from sherman_tpu_torch.workload.ycsb import YcsbGen
    t = time.perf_counter()
    _, tree, eng, keys = YB.build(n_keys, YCSB_OPS, nodes, device, log=_log)
    t_build = time.perf_counter() - t
    mirror = YcsbMirror(keys)
    rows, split, e_rows = {}, {}, 0
    scans = record_scans(eng)
    try:
        with ShapeLog() as log:
            for w in "ABCDEF":
                gen = YcsbGen(w, n_keys, theta=0.99, seed=17, salt=YB.SALT)
                drawn, draw = [], gen.batch

                def batch(n, drawn=drawn, draw=draw):
                    if len(drawn) == 1 and timers is not None:
                        timers.reset()      # the warm-up batch has played
                    drawn.append(draw(n))
                    return drawn[-1]

                gen.batch = batch
                timers = ScanTimers(tree, log) if w == "E" else None
                try:
                    rows[w] = YB.run_workload(eng, gen, ops=YCSB_OPS,
                                              steps=YCSB_STEPS)
                finally:
                    if timers is not None:
                        timers.close()
                if timers is not None:
                    split = {"wall_s": YCSB_OPS * YCSB_STEPS
                             / rows[w]["ops_s"], **timers.split(),
                             **timers.n}
                if eng.device.type == "cuda":
                    torch.cuda.synchronize()
                t = time.perf_counter()     # outside the timed wall
                for i, b in enumerate(drawn):
                    mirror.play(b)
                    if "scan" in b:
                        ranges, res = scans.pop(0)
                        if i:               # the timed steps
                            e_rows += mirror.check(ranges, res)
                rows[w]["mirror_check_s"] = time.perf_counter() - t
                _log(f"YCSB-{w} ({path}): {rows[w]['ops_s']:,.0f} ops/s, "
                     f"p50 {rows[w]['step_p50_ms']:.3f} / p99 "
                     f"{rows[w]['step_p99_ms']:.3f} ms a step")
    finally:
        del eng.range_query_many
    log.check(f"{path} ycsb", must_launch)
    if scans or not e_rows:
        raise AssertionError(f"{path}: {len(scans)} scan calls unchecked, "
                             f"{e_rows} rows checked")
    _log("ycsb_matrix: " + json.dumps({
        "metric": "ycsb_matrix", "path": path, "keys": n_keys,
        "batch": YCSB_OPS, "steps": YCSB_STEPS, "nodes": nodes,
        "batch_per_node": eng.B, "step_capacity": eng.cfg.step_capacity,
        "pages_per_node": eng.cfg.pages_per_node,
        "router_log2_buckets": eng.router.lb, "theta": 0.99,
        "build_s": t_build, "workloads": rows, "e_split_s": split,
        "e_rows_checked": e_rows, "reduced": reduced}))
    return replay(log, path), {"tree": tree, "eng": eng, "mirror": mirror,
                               "n_keys": n_keys}


# ---------------------------------------------------------------------------
# Integrity: the structure validator, the online scrubber with quarantine,
# chaos injection and degraded mode.
# ---------------------------------------------------------------------------

INTEG_OPS = 8192                # the matrix's step: one insert batch


def _same_obj(a, b) -> bool:
    """Exact equality of nested results: tensors, arrays, containers."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and np.array_equal(a, b)
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same_obj(x, y) for x, y in zip(a, b)))
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same_obj(a[k], b[k]) for k in a))
    return a == b


def _diff(a, b, depth: int = 0) -> str:
    """A short account of where two results differ."""
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)) \
            and len(a) == len(b) and depth < 3:
        return "; ".join(f"[{i}] {_diff(x, y, depth + 1)}"
                         for i, (x, y) in enumerate(zip(a, b))
                         if not _same_obj(x, y))
    if isinstance(a, (torch.Tensor, np.ndarray)) and \
            isinstance(b, (torch.Tensor, np.ndarray)):
        x, y = np.asarray(a), np.asarray(b)
        if x.shape != y.shape:
            return f"shapes {x.shape} vs {y.shape}: " \
                   f"{np.setdiff1d(x, y)[:8]} / {np.setdiff1d(y, x)[:8]}"
        idx = np.argwhere(x != y)
        return f"{len(idx)} elements differ, first at {idx[:4].tolist()}: " \
               f"{x[tuple(idx[0])]} vs {y[tuple(idx[0])]}"
    return f"{str(a)[:300]} vs {str(b)[:300]}"


def _outcome(fn):
    """-> ("ok", result), or ("raised", error class, message) for a typed
    refusal of the port (DegradedError, KeyRangeError, TreeCorruptError);
    any other error propagates."""
    from sherman_tpu_torch.errors import ShermanError
    try:
        return ("ok", fn())
    except ShermanError as e:
        return ("raised", type(e).__name__, str(e))


def _page_keys(dsm, addr: int) -> np.ndarray:
    from sherman_tpu_torch.ops import layout
    return np.array([k for k, _, _ in layout.np_leaf_entries(
        dsm.read_page(addr))], np.uint64)


def integrity_build(machine_nr: int, device: str,
                    step_capacity: int | None = None) -> dict:
    """20,000 keys (numpy seed 42, below 2^56, values ``3 * key``): three
    in four bulk-loaded at fill 0.9 with the router, the fourth inserted
    (shuffled), every sixth key and the 3,000 keys of ranks 6,000-8,999
    deleted, three reclaim passes, so retired, parked and freed pages
    exist.  One node: 4,096 pages, 512 rows; eight: 1,024 pages a node
    and ``step_capacity`` (32) rows a node.  -> {tree, eng, keys, model}."""
    from sherman_tpu_torch.cluster import Cluster
    from sherman_tpu_torch.config import DSMConfig, TreeConfig
    from sherman_tpu_torch.models import batched
    from sherman_tpu_torch.models.btree import Tree

    N = machine_nr
    B = step_capacity or 512
    rng = np.random.default_rng(42)
    keys = np.unique(rng.integers(1, 1 << 56, 21_000, dtype=np.uint64))
    keys = keys[:20_000]
    i = np.arange(keys.size)
    ins = keys[i % 4 == 3].copy()
    rng.shuffle(ins)
    dead = np.union1d(keys[::6], keys[6000:9000])
    tree = Tree(Cluster(DSMConfig(
        machine_nr=N, pages_per_node=4096 if N == 1 else 1024,
        locks_per_node=1024, step_capacity=B, chunk_pages=64,
        device=device)))
    eng = batched.BatchedEngine(tree, batch_per_node=B,
                                tcfg=TreeConfig(lock_retry_rounds=2))
    bulk = keys[i % 4 != 3]
    batched.bulk_load(tree, bulk, bulk * np.uint64(3), fill=0.9)
    eng.attach_router()
    eng.insert(ins, ins * np.uint64(3))
    eng.delete(dead)
    for _ in range(3):
        eng.reclaim_empty_leaves()
    live = np.setdiff1d(keys, dead)
    if not (eng._reclaim_state["parked"]
            and any(d.allocator.free_pages_list
                    for d in tree.cluster.directories)):
        raise AssertionError("integrity tree: no parked or no freed page")
    return {"tree": tree, "eng": eng, "keys": keys,
            "model": dict(zip(live.tolist(), (live * 3).tolist()))}


def _integrity_run(machine_nr: int, device: str, step_capacity) -> list:
    """The reference check's sequence on one device -> [(label, result)]:
    every result comparable across devices (tensors on the CPU)."""
    from sherman_tpu_torch import chaos as CH
    from sherman_tpu_torch.models import validate as V
    from sherman_tpu_torch.models.scrub import Scrubber
    from sherman_tpu_torch.parallel import dsm as D

    ctx = integrity_build(machine_nr, device, step_capacity)
    tree, eng, keys, model = ctx["tree"], ctx["eng"], ctx["keys"], \
        ctx["model"]
    dsm = tree.dsm
    out = []

    def state(label):
        # copies: on the CPU, .cpu() would alias the live state
        out.append((label, [t.to("cpu", copy=True) for t in (
            dsm.pool, dsm.locks, dsm.counters)] + [dsm.dirty_rows()]))

    state("built")
    out.append(("validate", V.check_structure_device(tree)))
    out.append(("scrub", V.scrub_pass(tree)))
    live = np.array(sorted(model), np.uint64)
    victim = int(tree._descend(int(live[live.size // 2]))[0])
    victim2 = int(tree._descend(int(live[live.size // 5]))[0])
    la = tree._lock_word_addr(victim)
    w200 = int(dsm.read_page(victim)[200])

    def stale_ops():
        dsm.read_word(0, 0)                     # step 0 arms the snapshot
        dsm.write_words(victim, 200, np.array([1234], np.int32))
        return dsm.read_page(victim)

    cases = (
        ("torn_page", [{"kind": "torn_page", "step": 0}],
         lambda: dsm.read_word(0, 0)),
        ("flip_entry_ver", [{"kind": "flip_entry_ver", "step": 0,
                             "slot": 7}], lambda: dsm.read_word(0, 0)),
        ("wedge_lock", [{"kind": "wedge_lock", "step": 0}],
         lambda: dsm.read_word(0, 0)),
        ("drop_cas", [{"kind": "drop_cas", "step": 0}],
         lambda: dsm.cas(la, 0, 0, tree.ctx.lease, space=D.SPACE_LOCK)),
        ("stale_read", [{"kind": "stale_read", "step": 2}], stale_ops))
    for kind, faults, ops in cases:
        plan = CH.FaultPlan(faults, seed=5)
        dsm.install_chaos(plan)
        rep = ops()
        dsm.install_chaos(None)
        if not plan.exhausted:
            raise AssertionError(f"integrity: {kind} did not fire")
        out.append((kind, (rep, plan.describe(), list(plan._undo))))
        state(kind)
        plan.undo(dsm)
    dsm.write_words(victim, 200, np.array([w200], np.int32))
    state("faults undone")

    # the scrubber: an entry-level fault quarantined, a structural one
    # degrading the engine, reads of the flagged pages, the repair
    scr = Scrubber(eng, interval=1)
    out.append(("scrub clean", scr.scrub()))
    pk, pk2 = _page_keys(dsm, victim), _page_keys(dsm, victim2)
    plans = []
    for label, fault in (("entry", {"kind": "flip_entry_ver",
                                    "addr": victim}),
                         ("structural", {"kind": "torn_page",
                                         "addr": victim2})):
        plans.append(_fire(dsm, CH.FaultPlan([fault])))
        res = scr.scrub()
        out.append((label + " scrub", res))
        out.append((label + " lease words", [
            dsm.read_word(w, 0, space=D.SPACE_LOCK)
            for w in sorted(scr._held_words)]))
        out.append((label + " degraded", eng.degraded_reason))
        out.append((label + " insert", _outcome(
            lambda: eng.insert(pk[:4], pk[:4] ^ np.uint64(1)))))
        out.append((label + " mixed", _outcome(
            lambda: eng.mixed(pk[:2], pk[:2], np.zeros(2, bool)))))
        for name, ks in (("flagged", pk), ("flagged2", pk2)):
            out.append((f"{label} search {name}", _outcome(
                lambda: eng.search(ks))))
            out.append((f"{label} search_combined {name}", _outcome(
                lambda: eng.search_combined(ks))))
        state(label)
    if not eng.degraded:
        raise AssertionError("integrity: the torn page did not degrade")
    out.append(("repair", (plans[1].undo(dsm), plans[0].undo(dsm),
                           _outcome(lambda: V.check_structure_device(tree)),
                           scr.scrub()["violations"],
                           scr.release_quarantine())))
    eng.exit_degraded()
    state("repaired")

    # tests/test_fuzz.py's chaos fuzz over this tree
    rng = np.random.default_rng(42)
    scr = Scrubber(eng, interval=1, quarantine=False)
    for it in range(8):
        plan = _fire(dsm, CH.FaultPlan.random(1000 + it, n_faults=2,
                                              step_hi=1))
        res = scr.scrub()
        if any(f.kind in ("torn_page", "flip_entry_ver")
               for f in plan.faults) and not res["violations"]:
            raise AssertionError(f"fuzz {it}: {plan.describe()} undetected")
        ks = rng.choice(keys, size=100, replace=True)
        vs = ks ^ np.uint64(it * 31 + 7)
        st = _outcome(lambda: eng.insert(ks, vs))
        if st[0] == "ok":
            done = st[1]
            if (done["applied"] + done["superseded"] + done["host_path"]
                    + done["lock_timeouts"]) != ks.size:
                raise AssertionError(f"fuzz {it}: {done}")
            timed_out = set(done["lock_timeout_keys"])
            for j in sorted(np.unique(ks, return_index=True)[1]):
                if int(ks[j]) not in timed_out:
                    model[int(ks[j])] = int(vs[j])
        elif st[1] != "DegradedError":
            raise AssertionError(f"fuzz {it}: {st}")
        n_undo = plan.undo(dsm)
        scr.flagged.clear()
        eng.exit_degraded()
        probe = rng.choice(keys, size=200, replace=False)
        v, f = eng.search(probe)
        want_f = np.array([int(k) in model for k in probe])
        want_v = np.array([model.get(int(k), 0) for k in probe], np.uint64)
        if not (np.array_equal(f, want_f)
                and np.array_equal(v[f], want_v[want_f])):
            raise AssertionError(f"fuzz {it}: reads disagree with the model")
        out.append((f"fuzz {it}", (plan.describe(), res, st, n_undo, v, f)))
        state(f"fuzz {it}")
    stats = V.check_structure_device(tree)
    if stats["keys"] != len(model):
        raise AssertionError(f"fuzz: {stats} for {len(model)} live keys")
    out.append(("fuzz end", stats))
    return out


def integrity_reference_check(machine_nr: int, devices=("cuda", "cpu"),
                              step_capacity: int | None = None) -> None:
    """Phase 17 on ``machine_nr`` nodes: :func:`_integrity_run` on the
    card and on the plain path on the CPU, every result and state
    bit-identical."""
    t = time.perf_counter()
    a, b = [_integrity_run(machine_nr, d, step_capacity) for d in devices]
    if [x for x, _ in a] != [x for x, _ in b]:
        raise AssertionError("integrity reference: the runs differ in shape")
    for (label, x), (_, y) in zip(a, b):
        if not _same_obj(x, y):
            raise AssertionError(f"integrity reference ({machine_nr} "
                                 f"node(s)): {label} differs between "
                                 f"{devices[0]} and {devices[1]}: "
                                 f"{_diff(x, y)}")
    _log(f"integrity reference check ({machine_nr} node(s), 20,000 keys, "
         f"{devices[0]} vs {devices[1]}): validator, scrub pass, the five "
         "fault kinds, quarantine, degraded mode, reads of flagged pages, "
         "repair, 8 fuzz iterations bit-identical "
         f"({len(a)} results; {time.perf_counter() - t:.1f} s)")


def timed_pass(what: str, fn, tree) -> tuple:
    """One integrity pass ``fn()``: its CUDA-event span and wall (the pass
    syncs to read its counts back, so the span holds the host's share
    too) and, on the card, its peak device memory
    (``max_memory_allocated`` after a reset) and what it added to the
    memory in use.  -> (result, record)."""
    on_card = tree.dsm.pool.device.type == "cuda"
    rec = {"what": what, "pages": tree.dsm.pool.shape[0],
           "device_ms": None, "peak_bytes": None, "added_bytes": None}
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
    t = time.perf_counter()
    out = fn()
    if on_card:
        b.record()
        b.synchronize()
        rec["device_ms"] = a.elapsed_time(b)
        rec["peak_bytes"] = torch.cuda.max_memory_allocated()
        rec["added_bytes"] = rec["peak_bytes"] - base
    rec["wall_ms"] = (time.perf_counter() - t) * 1e3
    return out, rec


def with_bound(rec: dict, stats: dict, entry: bool) -> dict:
    """The pass's bound: the bytes it must read, each word once, over the
    HBM rate.  The header words and the rear version of every row, the
    version and key words of every leaf slot (``stats``' leaves), the key
    words of every internal entry and, with ``entry`` (the validator),
    their child pointers."""
    from sherman_tpu_torch import config as C
    words = (rec["pages"] * (C.W_ENTRIES + 1)
             + stats["leaves"] * 3 * C.LEAF_CAP
             + stats["internal_pages"] * (3 if entry else 2)
             * C.INTERNAL_CAP)
    rec["bytes"] = 4 * words
    rec["bound_ms"] = rec["bytes"] / HBM_BYTES_PER_S * 1e3
    return rec


def timed_validate(tree, what: str, want_keys: int, passes: list) -> dict:
    """``check_structure_device`` timed by :func:`timed_pass`; its key
    count must be ``want_keys``.  The record goes to ``passes``."""
    from sherman_tpu_torch.models import validate as V
    stats, rec = timed_pass(what, lambda: V.check_structure_device(tree),
                            tree)
    if stats["keys"] != want_keys:
        raise AssertionError(f"{what}: {stats['keys']} keys in the tree, "
                             f"{want_keys} expected")
    passes.append({**with_bound(rec, stats, True), "stats": stats})
    _log(f"{what}: structure valid ({stats}) in {rec['wall_ms']:.1f} ms")
    return stats


def timed_scrub(scr, what: str, stats: dict, passes: list) -> dict:
    """``scr.scrub()`` timed by :func:`timed_pass`, its bound from the
    last validation's ``stats``.  The record goes to ``passes``."""
    res, rec = timed_pass(what, scr.scrub, scr.tree)
    passes.append({**with_bound(rec, stats, False),
                   "violations": res["violations"],
                   "classes": {k: v for k, v in res["classes"].items() if v}})
    return res


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _fire(dsm, plan):
    """Install a chaos plan, run one host step so its step-0 faults land,
    uninstall.  -> the plan."""
    dsm.install_chaos(plan)
    dsm.read_word(0, 0)
    dsm.install_chaos(None)
    if not plan.exhausted:
        raise AssertionError(f"faults {plan.describe()} did not fire")
    return plan


def _fence(dsm, addr: int) -> tuple[int, int]:
    from sherman_tpu_torch.ops import layout
    pg = dsm.read_page(addr)
    return layout.np_lowest(pg), layout.np_highest(pg)


def _outside(keys: np.ndarray, fences) -> np.ndarray:
    keep = np.ones(keys.size, bool)
    for lo, hi in fences:
        keep &= ~((keys >= np.uint64(lo)) & (keys < np.uint64(hi)))
    return keep


def fresh_keys(rng, mirror, n: int, fences=()) -> np.ndarray:
    """``n`` distinct keys absent from the live set and outside the
    ``fences``, in random order."""
    from sherman_tpu_torch import config as C
    cand = np.unique(rng.integers(C.KEY_MIN, C.KEY_MAX, 4 * n,
                                  dtype=np.uint64))
    cand = cand[~mirror.lookup(cand)[1] & _outside(cand, fences)]
    rng.shuffle(cand)
    if cand.size < n:
        raise AssertionError("fresh_keys: too few candidates")
    return cand[:n]


def integrity_full_width(ctx: dict, passes: list, smi: str) -> dict:
    """Phase 19 on the YCSB matrix's 100 M-key tree (``ctx`` from
    :func:`ycsb_matrix`): (a) the validator, keys equal to the live
    mirror; (b) a clean scrub; (c) ``flip_entry_ver`` on a leaf:
    flagged ``torn_slot``, quarantined, no degrade, an insert batch lands
    everywhere but the fenced pages, the victim's key timed out with the
    typed status; (d) ``torn_page`` on a second leaf: ``bad_version``,
    degraded, every write entry point refused, a zipf 0.99 batch (less the
    flagged pages' keys) answered as the mirror says by
    ``search_combined`` and an all-read ``mixed``; (e) undo, a green
    validation and a clean scrub, the quarantine released, degraded mode
    left; a dead lease wedged on a leaf the next batch writes, the batch
    landing through the engine's lease revocation, every key searched
    back; (f) the ``integrity`` line.  Every serving step runs in one
    launch window (K1-K3 must launch, K1 and K2 in (d)'s reads, all three
    in (e)'s batch), replayed as the ``one_node_integrity`` path.
    -> {kernel: [shapes]}."""
    from sherman_tpu_torch import chaos as CH
    from sherman_tpu_torch import ycsb_bench as YB
    from sherman_tpu_torch.models import batched
    from sherman_tpu_torch.models.scrub import Scrubber
    from sherman_tpu_torch.models.validate import SCRUB_BITS
    from sherman_tpu_torch.ops import bits
    from sherman_tpu_torch.parallel import dsm as D
    from sherman_tpu_torch.workload.ycsb import YcsbGen
    tree, eng, mirror = ctx["tree"], ctx["eng"], ctx["mirror"]
    dsm, path = tree.dsm, "one_node_integrity"
    rng = np.random.default_rng(19)
    rec: dict = {"metric": "integrity", "path": path,
                 "pages": dsm.pool.shape[0]}
    # a, b
    stats = timed_validate(tree, "19a validate", mirror.live, passes)
    scr = Scrubber(eng, interval=1)
    res = timed_scrub(scr, "19b scrub", stats, passes)
    if res["violations"] or res["degraded"]:
        raise AssertionError(f"19b: {res}")
    # c: an entry-level fault
    k1 = mirror.keys[mirror.keys.size // 3]
    v1 = int(tree._descend(int(k1))[0])
    plan_c = _fire(dsm, CH.FaultPlan([{"kind": "flip_entry_ver", "addr": v1,
                                       "slot": 0}]))
    res = timed_scrub(scr, "19c scrub", stats, passes)
    if (res["bad"] != [(v1, SCRUB_BITS["torn_slot"])] or res["degraded"]
            or not res["quarantined"]):
        raise AssertionError(f"19c: {res}")
    rec["c"] = {k: res[k] for k in ("classes", "quarantined", "degraded")}
    fence1 = _fence(dsm, v1)
    held = set(scr._held_words)
    with ShapeLog() as log:
        # the launches so far, as the window's spies count them
        launches = lambda: {k: sum(log.counts.get(k, {}).values())
                            for k in ("descent_round", "gather_pages",
                                      "writeback")}
        ins = np.append(fresh_keys(rng, mirror, INTEG_OPS - 1, [fence1]),
                        k1)
        vals = ins ^ np.uint64(0x1D1D)
        t = time.perf_counter()
        st = eng.insert(ins, vals)
        insert_ms = (time.perf_counter() - t) * 1e3
        to = np.asarray(st["lock_timeout_keys"], np.uint64)
        if int(k1) not in set(to.tolist()) or (
                st["applied"] + st["superseded"] + st["host_path"]
                + st["lock_timeouts"]) != ins.size:
            raise AssertionError(f"19c insert: {st}")
        fenced = {tree._lock_word_addr(int(tree._descend(int(k))[0]))
                  for k in to}
        if not fenced <= held:
            raise AssertionError("19c: a key outside the quarantined "
                                 "pages timed out")
        status = eng.mixed(ins[-1:], vals[-1:], np.zeros(1, bool))[2]
        if status[0] != batched.ST_LOCK_TIMEOUT:
            raise AssertionError(f"19c: mixed status {status}")
        landed = ~np.isin(ins, to)
        mirror.add(ins[landed], vals[landed])
        v, f = eng.search_combined(ins)
        want_v, want_f = mirror.lookup(ins)
        if not (np.array_equal(f, want_f) and np.array_equal(v, want_v)):
            raise AssertionError("19c: the insert batch reads back wrong")
        rec["c"].update(insert_keys=int(ins.size), landed=int(landed.sum()),
                        lock_timeouts=int(st["lock_timeouts"]),
                        victim_status=int(status[0]), insert_ms=insert_ms)
        # d: a structural fault
        k2 = mirror.keys[2 * mirror.keys.size // 3]
        v2 = int(tree._descend(int(k2))[0])
        plan_d = _fire(dsm, CH.FaultPlan([{"kind": "torn_page", "addr": v2}]))
        res = timed_scrub(scr, "19d scrub", stats, passes)
        if ((v2, SCRUB_BITS["bad_version"]) not in res["bad"]
                or res["new_violations"] != 1 or not res["degraded"]):
            raise AssertionError(f"19d: {res}")
        rec["d"] = {k: res[k] for k in ("classes", "quarantined",
                                        "degraded")}
        refused = []
        two = mirror.keys[:2]
        for name, fn in (
                ("insert", lambda: eng.insert(two, two)),
                ("delete", lambda: eng.delete(two)),
                ("mixed", lambda: eng.mixed(two, two,
                                            np.array([True, False]))),
                ("reclaim_empty_leaves", eng.reclaim_empty_leaves)):
            try:
                fn()
            except batched.DegradedError:
                refused.append(name)
            else:
                raise AssertionError(f"19d: {name} accepted while degraded")
        gen = YcsbGen("C", ctx["n_keys"], theta=0.99, seed=29, salt=YB.SALT)
        q = gen.batch(INTEG_OPS)["read"]
        q = q[_outside(q, [fence1, _fence(dsm, v2)])]
        before = launches()
        t = time.perf_counter()
        v, f = eng.search_combined(q)
        t1 = time.perf_counter()
        ov, fnd, _ = eng.mixed(q, q, np.ones(q.size, bool))
        t2 = time.perf_counter()
        after = launches()
        want_v, want_f = mirror.lookup(q)
        if not (want_f.all() and np.array_equal(f, want_f)
                and np.array_equal(v, want_v) and np.array_equal(fnd, want_f)
                and np.array_equal(ov, want_v)):
            raise AssertionError("19d: degraded reads disagree with the "
                                 "mirror")
        if not all(after[k] > before[k]
                   for k in ("descent_round", "gather_pages")):
            raise AssertionError(f"19d reads: launches {before} -> {after}")
        rec["d"].update(refused=refused, reads_checked=int(q.size),
                        search_combined_ms=(t1 - t) * 1e3,
                        read_mixed_ms=(t2 - t1) * 1e3)
        # e: repair, then a wedged lock under the next batch
        undone = plan_d.undo(dsm) + plan_c.undo(dsm)
        stats = timed_validate(tree, "19e validate", mirror.live, passes)
        res = timed_scrub(scr, "19e scrub", stats, passes)
        if res["violations"] or undone != 2:
            raise AssertionError(f"19e: {undone} words undone, {res}")
        released = scr.release_quarantine()
        eng.exit_degraded()
        batch = fresh_keys(rng, mirror, INTEG_OPS)
        la = tree._lock_word_addr(int(tree._descend(int(batch[0]))[0]))
        _fire(dsm, CH.FaultPlan([{"kind": "wedge_lock", "addr": la}]))
        dead = dsm.read_word(la, 0, space=D.SPACE_LOCK)
        if bits.lease_owner(dead) != 0xDEAD:
            raise AssertionError(f"19e: lock word {dead:#x} not wedged")
        recover, calls = eng._recover_wedged_locks, []
        eng._recover_wedged_locks = lambda k: calls.append(k.size) \
            or recover(k)
        before = launches()
        t = time.perf_counter()
        try:
            st = eng.insert(batch, batch ^ np.uint64(0x2E2E))
        finally:
            del eng._recover_wedged_locks
        insert_ms = (time.perf_counter() - t) * 1e3
        after = launches()
        if st["lock_timeouts"] or (st["applied"] + st["superseded"]
                                   + st["host_path"]) != batch.size \
                or not calls \
                or dsm.read_word(la, 0, space=D.SPACE_LOCK) != 0:
            raise AssertionError(f"19e insert: {st}, recoveries {calls}")
        if not all(after[k] > before[k] for k in after):
            raise AssertionError(f"19e insert: launches {before} -> {after}")
        mirror.add(batch, batch ^ np.uint64(0x2E2E))
        v, f = eng.search_combined(batch)
        if not (f.all() and np.array_equal(v, batch ^ np.uint64(0x2E2E))):
            raise AssertionError("19e: the batch reads back wrong")
        rec["e"] = {"words_undone": undone, "quarantine_released": released,
                    "wedged_lock": la, "recoveries": len(calls),
                    "batch_landed": int(batch.size), "insert_ms": insert_ms}
        timed_validate(tree, "19e final validate", mirror.live, passes)
    log.check(path, ("descent_round", "gather_pages", "writeback"))
    rec.update(keys=mirror.live, passes=passes, card=smi)
    print(json.dumps(rec), flush=True)
    return replay(log, path)


# ---------------------------------------------------------------------------
# Durability: the op journal, checkpoint chains in the JAX package's npz
# format, crash recovery and targeted repair.
# ---------------------------------------------------------------------------

DUR_OPS = 8192                  # the matrix's step: one acknowledged batch
DUR_DELTA_OPS = 1_000_000       # tools/ckpt_bench.py: keys/100 capped at 1 M


class Spans:
    """While open, wraps ``mod.attr`` for each given attribute and sums the
    calls and the wall seconds spent in each (the smoke's own account of a
    library call's parts; nothing is added to the library)."""

    def __init__(self, mod, *attrs):
        self.mod, self.attrs = mod, attrs
        self.calls = {a: 0 for a in attrs}
        self.s = {a: 0.0 for a in attrs}

    def __enter__(self):
        self._orig = {a: getattr(self.mod, a) for a in self.attrs}
        for a, fn in self._orig.items():
            def spy(*args, _a=a, _fn=fn, **kw):
                t = time.perf_counter()
                try:
                    return _fn(*args, **kw)
                finally:
                    self.calls[_a] += 1
                    self.s[_a] += time.perf_counter() - t
            setattr(self.mod, a, spy)
        return self

    def __exit__(self, *exc) -> bool:
        for a, fn in self._orig.items():
            setattr(self.mod, a, fn)
        return False


def _rpo(eng, keys, want_v, want_f) -> int:
    """Acknowledged ops whose effect is missing: a key absent or holding
    another value, or a deleted (or never acknowledged) key present."""
    v, f = eng.search(keys)
    return int((f != want_f).sum() + (f & want_f & (v != want_v)).sum())


def _durability_run(machine_nr: int, device: str, step_capacity,
                    rdir: str) -> list:
    """The durability reference check's sequence on one device ->
    [(label, result)], every result comparable across devices."""
    from sherman_tpu_torch import chaos as CH
    from sherman_tpu_torch.config import TreeConfig
    from sherman_tpu_torch.models.scrub import Scrubber
    from sherman_tpu_torch.recovery import RecoveryPlane
    from sherman_tpu_torch.utils import journal as J
    from sherman_tpu_torch.utils import sorted_unique

    ctx = integrity_build(machine_nr, device, step_capacity)
    tree, eng, model = ctx["tree"], ctx["eng"], ctx["model"]
    B = eng.B
    out = []

    def state(label, tree):
        d = tree.dsm
        out.append((label, [t.to("cpu", copy=True) for t in (
            d.pool, d.locks, d.counters)] + [d.dirty_rows(), [
                (x.allocator._next, x.root_ptr, x.root_level,
                 x.allocator.free_pages_list)
                for x in tree.cluster.directories]]))

    def rpo(eng, absent):
        ks = np.array(sorted(set(model) | absent), np.uint64)
        want_f = np.array([int(k) in model for k in ks])
        want_v = np.array([model.get(int(k), 0) for k in ks], np.uint64)
        return _rpo(eng, ks, want_v, want_f)

    rng = np.random.default_rng(42)
    absent: set = set()

    def fresh(n):
        ks = sorted_unique(rng.integers(1, 1 << 56, 2 * n, dtype=np.uint64))
        ks = ks[~np.isin(ks, np.fromiter(model, np.uint64, len(model)))]
        rng.shuffle(ks)
        return ks[:n]

    def ack_insert(ks, vs):
        st = eng.insert(ks, vs)
        if st["lock_timeouts"]:
            raise AssertionError(f"durability: {st}")
        model.update(zip(ks.tolist(), vs.tolist()))
        return st

    def ack_delete(ks):
        found = eng.delete(ks)
        for k in ks[found].tolist():
            model.pop(k, None)
            absent.add(k)
        return found

    plane = RecoveryPlane(tree.cluster, tree, eng, rdir, group_commit_ms=2.0)
    plane.checkpoint_base()
    state("base", tree)
    live = np.array(sorted(model), np.uint64)
    out.append(("insert", ack_insert(*(lambda k: (k, k * np.uint64(5)))(
        fresh(600)))))
    mk = np.concatenate([rng.choice(live, 200), fresh(50)])
    rd = rng.random(mk.size) < 0.3
    res = eng.mixed(mk, mk ^ np.uint64(0x33), rd)
    w = ~rd
    model.update(zip(mk[w].tolist(), (mk[w] ^ np.uint64(0x33)).tolist()))
    out.append(("mixed", res))
    out.append(("delete", ack_delete(rng.choice(live, 300, replace=False))))
    out.append(("reclaim", eng.reclaim_empty_leaves()))
    info = plane.checkpoint_delta()
    with np.load(info["path"]) as z:
        out.append(("delta", (info["pages"], z["delta_rows"],
                              z["delta_pages"])))
    state("delta", tree)
    out.append(("insert 2", ack_insert(*(lambda k: (k, k ^ np.uint64(9)))(
        fresh(200)))))
    out.append(("delete 2", ack_delete(np.append(
        rng.choice(live, 50, replace=False), np.uint64(3)))))
    seg = eng.journal.path
    with open(seg, "rb") as f:
        out.append(("journal bytes", f.read()))
    plane.close()
    torn = np.uint64(1 << 57)
    absent.add(int(torn))
    rec = J.encode_record(J.J_UPSERT, np.asarray([torn]), np.asarray([torn]))
    with open(seg, "ab") as f:
        f.write(rec[: len(rec) // 2])
    del plane, tree, eng, ctx
    tcfg = TreeConfig(lock_retry_rounds=2)
    plane, cl, tree, eng, receipt = RecoveryPlane.recover(
        rdir, device=device, batch_per_node=B, tcfg=tcfg,
        group_commit_ms=2.0)
    out.append(("recover", (receipt["chain"]["deltas"], receipt["replay"])))
    state("recovered", tree)
    rpo_recovered = rpo(eng, absent)
    out.append(("rpo recovered", rpo_recovered))
    # chaos on two live leaves, the scrubber, the targeted repair
    live = np.array(sorted(model), np.uint64)
    v1 = int(tree._descend(int(live[live.size // 3]))[0])
    v2 = int(tree._descend(int(live[2 * live.size // 3]))[0])
    _fire(tree.dsm, CH.FaultPlan([{"kind": "torn_page", "addr": v1},
                                  {"kind": "flip_entry_ver", "addr": v2,
                                   "slot": 1}]))
    scr = Scrubber(eng, interval=1)
    res = scr.scrub()
    if not res["degraded"] or res["violations"] != 2:
        raise AssertionError(f"durability scrub: {res}")
    out.append(("scrub", res))
    rep = plane.targeted_repair(scr)
    out.append(("repair", {k: v for k, v in rep.items()
                           if k != "repair_ms"}))
    state("repaired", tree)
    rpo_repaired = rpo(eng, absent)
    out.append(("rpo repaired", rpo_repaired))
    plane.close()
    if rpo_recovered or rpo_repaired:
        raise AssertionError(f"durability ({device}): RPO {rpo_recovered} "
                             f"after recover, {rpo_repaired} after repair")
    return out


def durability_reference_check(machine_nr: int, devices=("cuda", "cpu"),
                               step_capacity: int | None = None) -> None:
    """Phase 20 on ``machine_nr`` nodes: :func:`_durability_run` on the
    card and on the plain path on the CPU, every result, journal byte and
    state bit-identical."""
    t = time.perf_counter()
    runs = []
    for d in devices:
        rdir = tempfile.mkdtemp(prefix="sherman_dur_ref_")
        try:
            runs.append(_durability_run(machine_nr, d, step_capacity, rdir))
        finally:
            shutil.rmtree(rdir, ignore_errors=True)
    a, b = runs
    if [x for x, _ in a] != [x for x, _ in b]:
        raise AssertionError("durability reference: the runs differ in "
                             "shape")
    for (label, x), (_, y) in zip(a, b):
        if not _same_obj(x, y):
            raise AssertionError(f"durability reference ({machine_nr} "
                                 f"node(s)): {label} differs between "
                                 f"{devices[0]} and {devices[1]}: "
                                 f"{_diff(x, y)}")
    _log(f"durability reference check ({machine_nr} node(s), 20,000 keys, "
         f"{devices[0]} vs {devices[1]}): journal bytes, the delta's rows "
         "and pages, the recovered and repaired pools, locks, counters and "
         f"directories bit-identical, RPO 0 ({len(a)} results; "
         f"{time.perf_counter() - t:.1f} s)")


def _full_save_split(spans: Spans) -> dict:
    """A full save's wall split from the spans of ``utils/checkpoint``:
    the device-to-host copy, the content CRCs, ``savez_compressed`` with
    the write, and the fsyncs (file and directory)."""
    return {"d2h_s": spans.s["_state_arrays"],
            "crc_s": spans.s["_integrity"],
            "savez_write_s": spans.s["_savez_atomic"] - spans.s["_fsync"],
            "fsync_s": spans.s["_fsync"], "fsyncs": spans.calls["_fsync"]}


def durability_full_width(ctx: dict, smi: str) -> dict:
    """Phase 21 on the YCSB matrix's 100 M-key tree (``ctx`` from
    :func:`ycsb_matrix`, after phase 19), ``tools/recovery_drill.py``'s
    sequence at ``tools/ckpt_bench.py``'s sizes: (a) a ``RecoveryPlane``
    (group commit 2 ms) and its base, the save's wall split; (b) 8
    batches of 8,192 fresh inserts, 8 all-write ``mixed`` batches of 8,192
    zipf 0.99 updates and one ``delete`` of a zipf batch, every ack in the
    host ledger (the mirror), the journal's counts and the ack time it
    adds (one batch with it attached and detached, in turns); (c) 1 M
    clustered upserts and the delta beside the full save; (d) more
    batches, a torn half-record, the crash (engine, tree and cluster
    dropped, their device memory freed) and ``recover``; (e) RPO 0 over
    the ledger, the torn record absent and cut once, a 200,000-key probe,
    the validator; (f) new traffic, ``torn_page`` and ``flip_entry_ver``
    on live leaves, the scrubber's quarantine and degrade, the targeted
    repair (no full restore), the keys again; (g) K1-K3 replayed at every
    shape of the three windows (b-c, d-e, f); (h) the ``durability``
    line.  The directory is a temporary one, removed at the end.
    -> {kernel: [shapes]}."""
    from sherman_tpu_torch import chaos as CH
    from sherman_tpu_torch import obs
    from sherman_tpu_torch import ycsb_bench as YB
    from sherman_tpu_torch.ckpt_bench import journal_group_commit_ab
    from sherman_tpu_torch.models import batched
    from sherman_tpu_torch.models.scrub import Scrubber
    from sherman_tpu_torch.recovery import RecoveryPlane
    from sherman_tpu_torch.utils import checkpoint as CK
    from sherman_tpu_torch.utils import journal as J
    from sherman_tpu_torch.utils import sorted_unique
    from sherman_tpu_torch.workload.ycsb import YcsbGen

    tree, eng, mirror = ctx.pop("tree"), ctx.pop("eng"), ctx["mirror"]
    path, kern = "one_node_durability", ("descent_round", "gather_pages",
                                         "writeback")
    B, tcfg = eng.B, eng.tcfg
    dev = tree.dsm.pool.device.type         # "cpu" only in a rehearsal
    on_card = dev == "cuda"
    pool_bytes = tree.dsm.pool.numel() * 4
    rdir = tempfile.mkdtemp(prefix="sherman_durability_")
    # the base, the re-base's tmp file beside it and the deltas: at most
    # two full artifacts (each at most the raw pool) at once
    free = shutil.disk_usage(rdir).free
    if free < 2 * pool_bytes + (1 << 30):
        shutil.rmtree(rdir, ignore_errors=True)
        raise AssertionError(f"durability: {free / 1e9:.1f} GB free under "
                             f"{rdir}, {(2 * pool_bytes + (1 << 30)) / 1e9:.1f}"
                             " GB needed for the checkpoints")
    rng = np.random.default_rng(21)
    gen = YcsbGen("C", ctx["n_keys"], theta=0.99, seed=21, salt=YB.SALT)
    acked: list = []
    rec: dict = {"metric": "durability", "path": path,
                 "pages": tree.dsm.pool.shape[0], "pool_bytes": pool_bytes,
                 "group_commit_ms": 2.0, "card": smi}
    shapes: dict = {}
    passes: list = []
    save_spans = ("_state_arrays", "_integrity", "_savez_atomic", "_fsync")

    def ack_insert(eng, ks, vs):
        st = eng.insert(ks, vs)
        if st["lock_timeouts"]:
            raise AssertionError(f"durability insert: {st}")
        mirror.add(ks, vs)
        acked.append(ks)

    def ack_update(eng, ks, x):
        _, _, st = eng.mixed(ks, ks ^ np.uint64(x), np.zeros(ks.size, bool))
        if not np.isin(st, (batched.ST_APPLIED, batched.ST_SUPERSEDED)).all():
            raise AssertionError("durability: an update was not applied")
        mirror.add(ks, ks ^ np.uint64(x))
        acked.append(ks)

    def ledger_rpo(eng) -> int:
        ks = sorted_unique(np.concatenate(acked))
        want_v, want_f = mirror.lookup(ks)
        return _rpo(eng, ks, want_v, want_f)

    try:
        # a: the plane and its base
        plane = RecoveryPlane(tree.cluster, tree, eng, rdir,
                              group_commit_ms=2.0)
        with Spans(CK, *save_spans) as sp:
            t = time.perf_counter()
            base = plane.checkpoint_base()
            rec["base"] = {"s": time.perf_counter() - t,
                           "bytes": base["bytes"], **_full_save_split(sp)}
        _log(f"21a base: {rec['base']}")
        with ShapeLog() as log:
            # b: acknowledged traffic
            t = time.perf_counter()
            for i in range(8):
                ks = fresh_keys(rng, mirror, DUR_OPS)
                ack_insert(eng, ks, ks ^ np.uint64(0x21))
            t1 = time.perf_counter()
            for i in range(8):
                ack_update(eng, gen.batch(DUR_OPS)["read"], 0x22)
            t2 = time.perf_counter()
            dk = sorted_unique(gen.batch(DUR_OPS)["read"])
            found = eng.delete(dk)
            t3 = time.perf_counter()
            if not found.all():
                raise AssertionError("durability: a live key not deleted")
            mirror.remove(dk)
            acked.append(dk)
            j = eng.journal
            rec["b"] = {"insert_batches_s": t1 - t, "mixed_batches_s": t2 - t1,
                        "delete_keys": int(dk.size), "delete_s": t3 - t2,
                        "journal": {**j.stats(),
                                    "bytes": os.path.getsize(j.path)}}
            # the journal's share of one ack: the same update batch with
            # the journal attached and detached, in turns
            q = gen.batch(DUR_OPS)["read"]
            ack_update(eng, q, 0x23)
            walls = {"attached": [], "detached": []}
            for mode in ("attached", "detached", "detached", "attached"):
                if mode == "detached":
                    eng.attach_journal(None)
                t = time.perf_counter()
                eng.mixed(q, q ^ np.uint64(0x23), np.zeros(q.size, bool))
                walls[mode].append((time.perf_counter() - t) * 1e3)
                eng.attach_journal(j)
            rec["b"]["ack_ms"] = {k: float(np.mean(v))
                                  for k, v in walls.items()}
            rec["b"]["journal_ack_ms"] = (rec["b"]["ack_ms"]["attached"]
                                          - rec["b"]["ack_ms"]["detached"])
            # c: the delta A/B, 1 M clustered upserts
            dkeys = mirror.keys[:DUR_DELTA_OPS]
            t = time.perf_counter()
            ack_insert(eng, dkeys, dkeys ^ np.uint64(0x5EED))
            t1 = time.perf_counter()
            delta = plane.checkpoint_delta()
            rec["c"] = {"ops": int(dkeys.size), "traffic_s": t1 - t,
                        "s": time.perf_counter() - t1,
                        "pages": delta["pages"], "bytes": delta["bytes"],
                        "full_s": rec["base"]["s"],
                        "full_bytes": rec["base"]["bytes"]}
            _log(f"21b-c: {rec['b']} {rec['c']}")
        log.check(f"{path} b-c", kern)
        for k, v in replay(log, path).items():
            shapes.setdefault(k, []).extend(v)
        del log
        # d: more acknowledged batches, a torn tail, the crash
        for i in range(2):
            ks = fresh_keys(rng, mirror, DUR_OPS)
            ack_insert(eng, ks, ks ^ np.uint64(0x24))
        ack_update(eng, gen.batch(DUR_OPS)["read"], 0x25)
        seg = eng.journal.path
        plane.close()
        torn = fresh_keys(rng, mirror, 4)
        tr = J.encode_record(J.J_UPSERT, torn, torn)
        with open(seg, "ab") as f:
            f.write(tr[: len(tr) // 2])
        mem = {"before_crash": torch.cuda.memory_allocated()
               if on_card else None}
        pool = weakref.ref(tree.dsm.pool)
        del plane, tree, eng
        gc.collect()
        if pool() is not None:
            raise AssertionError("durability: the crash left the pool "
                                 "referenced")
        if on_card:
            torch.cuda.empty_cache()
            mem["after_crash"] = torch.cuda.memory_allocated()
        with ShapeLog() as log, Spans(J, "_truncate") as cut, \
                Spans(CK, *save_spans) as sp:
            t = time.perf_counter()
            plane, cluster, tree, eng, receipt = RecoveryPlane.recover(
                rdir, device=dev, batch_per_node=B, tcfg=tcfg,
                group_commit_ms=2.0)
            rto_s = time.perf_counter() - t
            if on_card:
                mem["recovered"] = torch.cuda.memory_allocated()
            # e: verification
            t = time.perf_counter()
            rpo = ledger_rpo(eng)
            _, tf = eng.search(torn)
            probe = mirror.keys[np.linspace(0, mirror.keys.size - 1,
                                            200_000).astype(np.int64)]
            pv, pf = eng.search_combined(probe)
            wv, wf = mirror.lookup(probe)
            probe_bad = int((pf != wf).sum() + (pf & (pv != wv)).sum())
            verify_s = time.perf_counter() - t
        if rpo or tf.any() or probe_bad or cut.calls["_truncate"] != 1:
            raise AssertionError(
                f"durability recover: RPO {rpo}, torn keys found "
                f"{int(tf.sum())}, probe mismatches {probe_bad}, torn tails "
                f"cut {cut.calls['_truncate']}")
        rec["d"] = {"restore_ms": receipt["restore_ms"],
                    "replay_ms": receipt["replay_ms"],
                    "rebase_ms": receipt["rebase_ms"],
                    "rto_ms": receipt["restore_ms"] + receipt["replay_ms"]
                    + receipt["rebase_ms"], "wall_s": rto_s,
                    "replay": receipt["replay"],
                    "deltas": receipt["chain"]["deltas"],
                    "rebase": _full_save_split(sp), "device_bytes": mem}
        rec["e"] = {"rpo_ops": rpo, "acked_keys": int(sum(
                        a.size for a in acked)), "torn_keys_found": 0,
                    "truncated_tails": cut.calls["_truncate"],
                    "probe_keys": int(probe.size), "verify_s": verify_s}
        _log(f"21d-e: {rec['d']} {rec['e']}")
        log.check(f"{path} d-e", kern)
        for k, v in replay(log, path).items():
            shapes.setdefault(k, []).extend(v)
        del log
        timed_validate(tree, "21e validate", mirror.live, passes)
        # f: targeted repair
        with ShapeLog() as log:
            ks = fresh_keys(rng, mirror, DUR_OPS)
            ack_insert(eng, ks, ks ^ np.uint64(0x26))
            ack_update(eng, gen.batch(DUR_OPS)["read"], 0x27)
            k1 = mirror.keys[mirror.keys.size // 4]
            k2 = mirror.keys[3 * mirror.keys.size // 4]
            v1 = int(tree._descend(int(k1))[0])
            v2 = int(tree._descend(int(k2))[0])
            victims = np.concatenate([_page_keys(tree.dsm, v1),
                                      _page_keys(tree.dsm, v2)])
            _fire(tree.dsm, CH.FaultPlan([
                {"kind": "torn_page", "addr": v1},
                {"kind": "flip_entry_ver", "addr": v2, "slot": 0}]))
            scr = Scrubber(eng, interval=1)
            res = scr.scrub()
            if not (res["degraded"] and res["quarantined"]
                    and res["violations"] == 2):
                raise AssertionError(f"21f scrub: {res}")
            with Spans(CK, "restore", "restore_chain", "read_chain_rows") \
                    as sp:
                t = time.perf_counter()
                repair = plane.targeted_repair(scr)
                repair_s = time.perf_counter() - t
            if eng.degraded or sp.calls["restore"] \
                    or sp.calls["restore_chain"] \
                    or sp.calls["read_chain_rows"] != 1:
                raise AssertionError(f"21f repair: degraded {eng.degraded}, "
                                     f"calls {sp.calls}")
            rpo_f = ledger_rpo(eng)
            vv, vf = eng.search(victims)
            wv, wf = mirror.lookup(victims)
            if rpo_f or not (wf.all() and vf.all()
                             and np.array_equal(vv, wv)):
                raise AssertionError(f"21f: RPO {rpo_f} after the repair, "
                                     "or a victim page's key lost")
            rec["f"] = {"pages": repair["pages"],
                        "stale_pages": repair["stale_pages"],
                        "resurrected": repair["resurrected"],
                        "replay": repair["replay"],
                        "repair_ms": repair["repair_ms"],
                        "wall_s": repair_s,
                        "read_chain_rows_s": sp.s["read_chain_rows"],
                        "classes": {k: v for k, v in res["classes"].items()
                                    if v},
                        "full_restores": 0, "rpo_ops": rpo_f,
                        "victim_keys": int(victims.size)}
        log.check(f"{path} f", kern)
        for k, v in replay(log, path).items():
            shapes.setdefault(k, []).extend(v)
        del log
        rec["journal_group_commit"] = journal_group_commit_ab(
            directory=rdir)
        rec.update(rpo_ops=max(rec["e"]["rpo_ops"], rpo_f),
                   rto_ms=rec["d"]["rto_ms"], keys=mirror.live,
                   passes=passes)
        plane.close()
        # the drill's receipts on the plane's gauges
        obs.gauge("recovery.rpo_ops").set(rec["rpo_ops"])
        obs.gauge("recovery.rto_ms").set(rec["rto_ms"])
        ctx["tree"], ctx["eng"] = tree, eng     # phase 22 serves it
    finally:
        shutil.rmtree(rdir, ignore_errors=True)
    print(json.dumps(rec), flush=True)
    return shapes


# ---------------------------------------------------------------------------
# Phase 22: the observability plane.
# ---------------------------------------------------------------------------

OBS_SALT = 0x5E17AB1E5A17
OBS_XOR = 0xDEADBEEF
# registry families that differ by design between the packages (ROADMAP.md
# section 3): the kernels' launch counts and the transport's per-execution
# bytes against the reference's build counts, and the device ledger's
# first-call entries against its jit compiles
OBS_EXCLUDED = ("kernels.", "transport.", "device.")
# wall-time values: excluded from equality (their counts are not)
OBS_WALL_KEYS = ("recovery.rto_ms",)
OBS_WALL_FIELDS = ("dur_ms", "total_ms", "repair_ms", "compile_ms")
# artifact sizes: a chain's random nonce rides in every artifact and moves
# its deflated size by a few bytes, so only their presence is compared
OBS_NONCE_KEYS = ("ckpt.delta_bytes",)
OBS_NONCE_FIELDS = ("bytes",)
# the programs both packages put through their ledgers
OBS_BOTH_LABELS = ("engine.search", "engine.search_fanout", "engine.insert",
                   "engine.delete", "engine.mixed", "engine.parent_descend",
                   "staged.prep", "staged.verify", "staged_mixed.prep")


def port_obs_mods(device: str):
    """The port's module handles for :func:`obs_run` on ``device``."""
    import types

    from sherman_tpu_torch import chaos, obs, recovery
    from sherman_tpu_torch.cluster import Cluster
    from sherman_tpu_torch.config import DSMConfig, TreeConfig
    from sherman_tpu_torch.models import batched
    from sherman_tpu_torch.models.btree import Tree
    from sherman_tpu_torch.models.scrub import Scrubber
    from sherman_tpu_torch.obs import device as DEV
    from sherman_tpu_torch.ops import bits
    from sherman_tpu_torch.workload import device_prep
    return types.SimpleNamespace(
        Cluster=Cluster, cfg=lambda **kw: DSMConfig(device=device, **kw),
        TreeConfig=TreeConfig, Tree=Tree, batched=batched, obs=obs, DEV=DEV,
        chaos=chaos, recovery=recovery, Scrubber=Scrubber, prep=device_prep,
        mix64=bits.mix64_np, DegradedError=batched.DegradedError)


def obs_reset(m) -> None:
    """Zero one package's registry, tracer, recorder, SLO tracker and
    ledger in place."""
    m.obs.get_registry().reset()
    m.obs.get_tracer().reset()
    m.obs.get_recorder().clear()
    m.obs.get_slo().reset()
    m.DEV.get_ledger().reset()


def obs_delta(m, s0: dict, s1: dict) -> dict:
    """The registry delta under the stated exclusions: the differing
    families and wall-time values out, histograms and SLO classes by
    their counts, artifact sizes by their presence, zero entries
    dropped."""
    out = {}
    for k, v in m.obs.delta(s0, s1).items():
        if k.startswith(OBS_EXCLUDED) or k in OBS_WALL_KEYS:
            continue
        if k.startswith("slo.") and not k.endswith(("ops_total",
                                                      "batches_total")):
            continue
        if isinstance(v, dict):
            v = v["count"]
        if v:
            out[k] = v > 0 if k in OBS_NONCE_KEYS else v
    return out


def obs_events(m, rdir: str) -> list:
    """The flight events in order as (kind, fields): timestamps, sequence
    numbers, wall times and chain nonces dropped, artifact sizes reduced
    to their presence, ``rdir`` made relative."""
    out = []
    for e in m.obs.get_recorder().events():
        f = {}
        for k, v in (e.get("fields") or {}).items():
            if k in OBS_WALL_FIELDS or k == "cid":
                continue
            if k in OBS_NONCE_FIELDS:
                v = v > 0
            if isinstance(v, str) and v.startswith(rdir):
                v = "<dir>" + v[len(rdir):]
            f[k] = v
        out.append((e["kind"], f))
    return out


def obs_run(m, machine_nr: int, step_capacity: int | None,
            rdir: str) -> dict:
    """Phase 22a's op sequence on one package (``m``: module handles, see
    :func:`port_obs_mods`) -> {delta, events, spans, ledger, slo, ...}.

    20,000 keys ``mix64(rank ^ salt)`` (values ``key ^ 0xDEADBEEF``)
    bulk-loaded at fill 0.9 with the router; the plane reset; then
    staged YCSB-C (aligned) and YCSB-A (chained) windows of 3 steps with
    ``record_slo``, ``search_combined``, ``mixed`` (fresh keys retried
    through ``insert``), ``insert`` with splits, ``delete``, three
    ``reclaim_empty_leaves`` passes, ``range_query_many``, a
    ``RecoveryPlane`` base, writes and a delta, ``torn_page`` and
    ``flip_entry_ver`` on two leaves, a ``Scrubber`` pass (quarantine,
    degrade), a refused insert, ``targeted_repair``, a dead lease wedged
    on a leaf and revoked by the next insert.  Numpy seed 42."""
    N = machine_nr
    B = step_capacity or 512
    n_keys = 20_000
    U64 = np.uint64
    rng = np.random.default_rng(42)
    keys = np.sort(m.mix64(np.arange(n_keys, dtype=U64) ^ U64(OBS_SALT)))
    tree = m.Tree(m.Cluster(m.cfg(
        machine_nr=N, pages_per_node=4096 if N == 1 else 1024,
        locks_per_node=1024, step_capacity=B, chunk_pages=64)))
    eng = m.batched.BatchedEngine(tree, batch_per_node=B, write_combine=False,
                                  tcfg=m.TreeConfig(lock_retry_rounds=2))
    m.batched.bulk_load(tree, keys, keys ^ U64(OBS_XOR), fill=0.9)
    eng.attach_router()
    dsm = tree.dsm
    known = set(keys.tolist())

    def fresh(n):
        ks = np.unique(rng.integers(1, 1 << 56, 2 * n, dtype=U64))
        ks = ks[~np.isin(ks, np.fromiter(known, U64, len(known)))]
        rng.shuffle(ks)
        known.update(ks[:n].tolist())
        return ks[:n]

    # objects that earlier callers left in reference cycles (a value
    # heap's or a cache's weakly held pull collector) keep reporting until
    # the collector frees them: free them now, so the delta is this
    # sequence's alone
    gc.collect()
    obs_reset(m)
    reg = m.obs.get_registry()
    s0 = reg.snapshot()
    out = {}
    step, (new_carry, tb, rt, rk) = m.prep.make_staged_step(
        eng, n_keys=n_keys, theta=0.99, salt=OBS_SALT, batch=B, dev_b=B,
        log2_bins=16, fusion="aligned", sampler="table")
    carry, counters = new_carry(), dsm.counters
    t = time.perf_counter()
    for _ in range(3):
        counters, carry = step(dsm.pool, counters, tb, rt, rk, carry)
    carry = step.drain(carry)
    dsm.counters = counters
    step.record_slo(3, time.perf_counter() - t)
    out["staged_c"] = _ints(carry)
    step, (new_carry, tb, rt, rk) = m.prep.make_staged_mixed_step(
        eng, n_keys=n_keys, theta=0.99, salt=OBS_SALT, batch=B,
        read_ratio=0.5, dev_rb=B // 2, dev_wb=B // 2, log2_bins=16,
        fusion="chained")
    carry, pool, counters = new_carry(), dsm.pool, dsm.counters
    t = time.perf_counter()
    for _ in range(3):
        pool, counters, carry = step(pool, dsm.locks, counters, tb, rt, rk,
                                     carry)
    carry = step.drain(carry)
    dsm.pool, dsm.counters = pool, counters
    step.record_slo(3, time.perf_counter() - t)
    out["staged_a"] = _ints(carry)
    out["search_combined"] = eng.search_combined(
        rng.choice(keys[:4 * B], B * N // 2))
    mk = np.concatenate([rng.choice(keys, B * N // 2), fresh(B * N // 4)])
    out["mixed"] = eng.mixed(mk, mk ^ U64(0x33), rng.random(mk.size) < 0.5)
    ins = fresh(1500)
    out["insert"] = eng.insert(ins, ins * U64(5))
    dead = np.union1d(rng.choice(keys, 400, replace=False),
                      keys[5000:7000])
    out["delete"] = eng.delete(dead)
    out["reclaim"] = [eng.reclaim_empty_leaves() for _ in range(3)]
    out["scan"] = eng.range_query_many(
        [(int(keys[i]), int(keys[i + 60])) for i in (100, 4990, 9000)])
    plane = m.recovery.RecoveryPlane(tree.cluster, tree, eng, rdir)
    out["base"] = plane.checkpoint_base()["bytes"]
    ins = fresh(200)
    out["insert 2"] = eng.insert(ins, ins ^ U64(9))
    out["delta"] = plane.checkpoint_delta()["pages"]
    live = np.setdiff1d(keys, dead)
    v1 = int(tree._descend(int(live[live.size // 3]))[0])
    v2 = int(tree._descend(int(live[2 * live.size // 3]))[0])
    _fire(dsm, m.chaos.FaultPlan([{"kind": "torn_page", "addr": v1},
                                  {"kind": "flip_entry_ver", "addr": v2,
                                   "slot": 1}]))
    scr = m.Scrubber(eng, interval=1)
    out["scrub"] = scr.scrub()
    try:
        eng.insert(ins[:4], ins[:4])
        out["refused"] = False
    except m.DegradedError:
        out["refused"] = True
    rep = plane.targeted_repair(scr)
    out["repair"] = {k: v for k, v in rep.items() if k != "repair_ms"}
    v3 = int(tree._descend(int(live[live.size // 2]))[0])
    _fire(dsm, m.chaos.FaultPlan([{"kind": "wedge_lock",
                                   "addr": tree._lock_word_addr(v3)}]))
    k3 = live[live.size // 2: live.size // 2 + 2]
    out["revoked insert"] = eng.insert(k3, k3 ^ U64(0x77))
    plane.close()
    s1 = reg.snapshot()
    tracer = m.obs.get_tracer()
    out.update(
        delta=obs_delta(m, s0, s1), events=obs_events(m, rdir),
        spans={k: v["n"] for k, v in tracer.summary().items()},
        ledger={e["label"]: len(e["signatures"])
                for e in m.DEV.get_ledger().entries()},
        slo={c: (s["ops_total"], s["batches_total"])
             for c, s in m.obs.slo_window().items()},
        snapshot=s1, chrome=tracer.chrome_trace())
    return out


def obs_reference_check(machine_nr: int, devices=("cuda", "cpu"),
                        step_capacity: int | None = None) -> None:
    """Phase 22a on ``machine_nr`` nodes: :func:`obs_run` on the card and
    on the plain path on the CPU — registry deltas (under the stated
    exclusions), flight events, span names and counts, SLO counts and
    the ledger's programs equal, and on the card the ``kernels.*``
    launch counts equal to the wrappers' ``LAUNCHES``."""
    from sherman_tpu_torch.ops import page_kernels as PK
    from sherman_tpu_torch.parallel import transport_kernel as TK

    t = time.perf_counter()
    res = {}
    for d in devices:
        rdir = tempfile.mkdtemp(prefix="sherman_obs_")
        try:
            PK.reset_launches()
            TK.reset_launches()
            r = obs_run(port_obs_mods(d), machine_nr, step_capacity, rdir)
        finally:
            shutil.rmtree(rdir, ignore_errors=True)
        launches = {**PK.LAUNCHES, **TK.LAUNCHES}
        got = {k: r["snapshot"][f"kernels.{k}_launches"] for k in launches}
        if got != launches:
            raise AssertionError(f"obs ({d}): kernels collector {got} != "
                                 f"LAUNCHES {launches}")
        r["launches"] = launches
        res[d] = r
    a, b = (res[d] for d in devices)
    for k in ("delta", "events", "spans", "slo", "ledger", "staged_c",
              "staged_a", "insert", "insert 2", "refused", "repair",
              "revoked insert"):
        if a[k] != b[k]:
            raise AssertionError(f"obs reference check ({machine_nr} "
                                 f"nodes): {k} differs: {_diff(a[k], b[k])}")
    for k in ("search_combined", "mixed", "delete", "scan"):
        if not _same_obj(a[k], b[k]):
            raise AssertionError(f"obs reference check ({machine_nr} "
                                 f"nodes): {k} differs")
    if devices[0] == "cuda" and not sum(a["launches"].values()):
        raise AssertionError("obs reference check: no kernel launched on "
                             "the card")
    _log(f"obs reference check ({machine_nr} nodes, 20,000 keys, card vs "
         f"plain path on the CPU): {len(a['delta'])} registry deltas, "
         f"{len(a['events'])} flight events, {sum(a['spans'].values())} "
         f"spans, SLO {a['slo']}, ledger {a['ledger']} equal; card "
         f"launches {a['launches']}; {time.perf_counter() - t:.1f} s")


# the reference's drill order across phases 19-21 (tests/test_slo.py:292):
# the engine leaves degraded mode inside targeted_repair, before its
# closing event
FLIGHT_ORDER = ("chaos.inject", "scrub.violation", "scrub.quarantine",
                "engine.degraded_enter", "recovery.targeted_repair_begin",
                "engine.degraded_exit", "recovery.targeted_repair")
FLIGHT_PRESENT = ("checkpoint.save", "checkpoint.restore",
                     "recovery.checkpoint_base", "recovery.checkpoint_delta",
                     "recovery.recover", "lease.revoked")


def flight_record(bb: str) -> dict:
    """Phase 22b(e), taken before 22a resets the plane: dump the
    recorder, reload the bundle and check that phases 19-21 left the
    drill's events in order and phase 21 its recovery and checkpoint
    events; an auto-dump bundle of a degraded entry must exist in
    ``bb``."""
    from sherman_tpu_torch import obs
    rec = obs.get_recorder()
    path = rec.dump("phases_19_21", bb)
    with open(path) as f:
        od = json.load(f)["otherData"]
    kinds = [e["kind"] for e in od["flight_events"]]
    at, pos = -1, {}
    for k in FLIGHT_ORDER:
        if k not in kinds[at + 1:]:
            raise AssertionError(f"flight record: no {k} after position "
                                 f"{at} ({len(kinds)} events)")
        at = kinds.index(k, at + 1)
        pos[k] = at
    missing = [k for k in FLIGHT_PRESENT if k not in kinds]
    bundles = sorted(f for f in os.listdir(bb)
                     if "degraded_entry" in f and f.endswith(".json"))
    if missing or not bundles:
        raise AssertionError(f"flight record: missing {missing}, degraded "
                             f"bundles {bundles}")
    return {"events": len(kinds), "dropped": od["flight_dropped"],
            "order": pos, "faults": sorted({
                e["fields"]["fault"] for e in od["flight_events"]
                if e["kind"] == "chaos.inject"}),
            "counts": {k: kinds.count(k) for k in FLIGHT_ORDER
                       + FLIGHT_PRESENT},
            "degraded_bundles": len(bundles)}


FLIGHT_EVENTS = 1 << 18     # the flight ring's capacity for the whole run
OBS_AB_REPEATS = 3      # staged windows a side, interleaved
OBS_AB_STEPS = 8        # steps a window
# host-path windows a side: the walls of a small step's windows spread by
# up to ~10% on the card's shared host (H100 80GB HBM3 runs of this
# phase), so more of them resolve a share near 1%; 18 windows of 8 small
# steps cost under a second
OBS_HOST_REPEATS = 9


def _obs_env(on: bool) -> None:
    for k in ("SHERMAN_SLO", "SHERMAN_DEVICE_OBS"):
        os.environ[k] = "1" if on else "0"


def _ab_order(n: int) -> list:
    """on, off, off, on, on, off, ...: each side leads as often."""
    return [bool((i + i // 2) % 2 == 0) for i in range(2 * n)]


def obs_full_width(ctx: dict, flight: dict, smi: str,
                   batch_c: int = 1 << 22, batch_a: int = 1 << 20) -> dict:
    """Phase 22b on the 100 M-key tree phase 21 recovered: (a) staged
    YCSB-C aligned (4,194,304 clients) and YCSB-A chained (1,048,576),
    obs on and off interleaved, the ledger sealed around every window,
    the host syncs of a step on both sides; (b) the matrix's YCSB-A
    ``mixed`` steps of 8,192 ops the same way, and the cost of a span
    and of an SLO observation; (c) one registry snapshot against the
    smoke's own counts, its Prometheus text and JSONL written and read
    back; (d) the tracer's Chrome trace of one YCSB-A step and a
    ``device_trace`` of one staged step naming K1-K3; (e) the flight
    record of phases 19-21 (``flight``); (f) the ``obs`` line, and K1-K3
    replayed at every shape the phase launched (path ``one_node_obs``).
    -> {kernel: [shapes]}."""
    from sherman_tpu_torch import obs
    from sherman_tpu_torch import ycsb_bench as YB
    from sherman_tpu_torch.config import TreeConfig
    from sherman_tpu_torch.models import batched
    from sherman_tpu_torch.obs import device as DEV
    from sherman_tpu_torch.obs import slo as SLO
    from sherman_tpu_torch.ops import page_kernels as PK
    from sherman_tpu_torch.workload import device_prep as DP
    from sherman_tpu_torch.workload.ycsb import YcsbGen

    tree, eng = ctx["tree"], ctx["eng"]
    n_keys, dev = ctx["n_keys"], tree.dsm.pool.device
    salt, xor = YB.SALT, 0xD00D
    path = "one_node_obs"
    t_phase = time.perf_counter()
    # 22a's trees were built after this one: point the ``dsm`` collector
    # and the accountant's sources back at it
    tree.dsm.register_obs()
    led = DEV.get_ledger()
    reg = obs.get_registry()
    rec: dict = {"metric": "obs", "path": path, "card": smi,
                 "pages": tree.dsm.pool.shape[0],
                 "windows_a_side": OBS_AB_REPEATS,
                 "steps_a_window": OBS_AB_STEPS, "reduced": []}
    obs.get_slo().reset()
    obs.get_tracer().reset()
    tcfg = TreeConfig(sibling_chase_budget=1)
    eng_c = batched.BatchedEngine(tree, batch_per_node=batch_c, tcfg=tcfg)
    eng_a = batched.BatchedEngine(tree, batch_per_node=batch_a, tcfg=tcfg)
    eng_c.router = eng_a.router = eng.router
    pool, locks, counters = tree.dsm.pool, tree.dsm.locks, tree.dsm.counters
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    _obs_env(True)
    with ShapeLog() as log:
        # (a) staged: the read loop's cap from one sizing step (as the
        # bench sizes it), the mixed loop's at the class sizes
        step, (new_c, tb, rt, rk) = DP.make_staged_step(
            eng_c, n_keys=n_keys, theta=0.99, salt=salt, batch=batch_c,
            dev_b=batch_c, sampler="analytic", fusion="aligned",
            check_xor=xor)
        c = _ints(step(pool, counters, tb, rt, rk, new_c())[1])
        dev_b = min(batch_c, -(-int(c[4] * 1.02) // 8192) * 8192 + 16384)
        staged_t = (tb, rt, rk)
        cstep, (new_c, *_) = DP.make_staged_step(
            eng_c, n_keys=n_keys, theta=0.99, salt=salt, batch=batch_c,
            dev_b=dev_b, sampler="analytic", fusion="aligned",
            check_xor=xor, staged=staged_t)
        R = batch_a // 2
        mstep, (new_m, *tabs_m) = DP.make_staged_mixed_step(
            eng_a, n_keys=n_keys, theta=0.99, salt=salt, batch=batch_a,
            read_ratio=0.5, dev_rb=R, dev_wb=batch_a - R,
            sampler="analytic", fusion="chained", check_xor=xor,
            staged=staged_t)

        def c_window():
            carry = new_c()
            for _ in range(OBS_AB_STEPS):
                carry = cstep(pool, counters, *staged_t, carry)[1]
            return cstep.drain(carry)

        def a_window():
            carry = new_m()
            for _ in range(OBS_AB_STEPS):
                carry = mstep(pool, locks, counters, *staged_t, carry)[2]
            return mstep.drain(carry)

        staged_ab = {}
        slo_read = 0
        for name, window, stp, batch in (("ycsb_c_aligned", c_window,
                                          cstep, batch_c),
                                         ("ycsb_a_chained", a_window,
                                          mstep, batch_a)):
            window()                                   # warm-up
            walls = {True: [], False: []}
            outs = set()
            for on in _ab_order(OBS_AB_REPEATS):
                _obs_env(on)
                r0 = led.retraces
                with led.sealed_scope():
                    sync()
                    t = time.perf_counter()
                    carry = window()
                    sync()
                    dt = time.perf_counter() - t
                stp.record_slo(OBS_AB_STEPS, dt)
                if led.retraces != r0:
                    raise AssertionError(f"22b(a) {name}: "
                                         f"{led.retraces - r0} retraces in "
                                         "a sealed window")
                walls[on].append(dt)
                c = _ints(carry)
                if c[1] != 1:
                    raise AssertionError(f"22b(a) {name}: a cap overflowed "
                                         f"({c})")
                # fresh carries: every window serves the same steps
                outs.add(tuple(c[:3] if name.startswith("ycsb_c")
                               else (c[0], c[1], c[3])))
            if len(outs) != 1:
                raise AssertionError(f"22b(a) {name}: windows disagree "
                                     f"with obs on and off: {outs}")
            syncs = {}
            for on in (True, False):
                _obs_env(on)
                box = {"c": new_c() if stp is cstep else new_m()}
                if stp is cstep:
                    one = lambda: box.__setitem__("c", cstep(
                        pool, counters, *staged_t, box["c"])[1])
                else:
                    one = lambda: box.__setitem__("c", mstep(
                        pool, locks, counters, *staged_t, box["c"])[2])
                syncs[on] = count_syncs(one)
                stp.drain(box["c"])
            _obs_env(True)
            if syncs[True] != syncs[False]:
                raise AssertionError(f"22b(a) {name}: host syncs a step "
                                     f"{syncs[True]} with obs, "
                                     f"{syncs[False]} without")
            on_ms = min(walls[True]) / OBS_AB_STEPS * 1e3
            off_ms = min(walls[False]) / OBS_AB_STEPS * 1e3
            staged_ab[name] = {
                "batch": batch, "ms_per_step_on": on_ms,
                "ms_per_step_off": off_ms,
                "obs_share": (on_ms - off_ms) / off_ms,
                "walls_s_on": walls[True], "walls_s_off": walls[False],
                "host_syncs_per_step_on": syncs[True],
                "host_syncs_per_step_off": syncs[False],
                "retraces": 0, "receipts": list(outs.pop())}
            if name.startswith("ycsb_c"):
                staged_ab[name]["dev_b"] = dev_b
                slo_read = OBS_AB_REPEATS * OBS_AB_STEPS * batch_c
        rec["staged"] = staged_ab
        snap_a = reg.snapshot()
        if snap_a["slo.read.ops_total"] != slo_read \
                or snap_a["slo.mixed.ops_total"] \
                != OBS_AB_REPEATS * OBS_AB_STEPS * batch_a:
            raise AssertionError(
                f"22b(c): slo.read {snap_a['slo.read.ops_total']}, "
                f"slo.mixed {snap_a['slo.mixed.ops_total']} after (a)")

        # (b) the host path: the matrix's YCSB-A mixed steps of 8,192 ops
        gen = YcsbGen("A", n_keys, theta=0.99, seed=22, salt=salt)
        batches = []
        for _ in range(OBS_AB_STEPS):
            b = gen.batch(YCSB_OPS)
            ks = np.concatenate([b["read"], b["update"]])
            isr = np.zeros(ks.size, bool)
            isr[:b["read"].size] = True
            batches.append((ks, ks ^ np.uint64(0xBEEF), isr))

        def host_window():
            for ks, vs, isr in batches:
                eng.mixed(ks, vs, isr)

        host_window()                                  # warm-up
        walls = {True: [], False: []}
        c0 = tree.dsm.counter_snapshot()
        s0 = reg.snapshot()
        mixed0 = s0["slo.mixed.ops_total"]
        sp0 = obs.get_tracer().summary()
        for on in _ab_order(OBS_HOST_REPEATS):
            _obs_env(on)
            r0 = led.retraces
            with led.sealed_scope():
                t = time.perf_counter()
                host_window()
                dt = time.perf_counter() - t
            if led.retraces != r0:
                raise AssertionError("22b(b): a retrace in a sealed window")
            walls[on].append(dt)
        _obs_env(True)
        s1 = reg.snapshot()
        c1 = tree.dsm.counter_snapshot()
        sp1 = obs.get_tracer().summary()
        spans_step = (sum(v["n"] for v in sp1.values())
                      - sum(v["n"] for v in sp0.values())) / (
            2 * OBS_HOST_REPEATS * OBS_AB_STEPS)
        on_ms = min(walls[True]) / OBS_AB_STEPS * 1e3
        off_ms = min(walls[False]) / OBS_AB_STEPS * 1e3
        med = {on: float(np.median(w)) / OBS_AB_STEPS * 1e3
               for on, w in walls.items()}
        tracer = obs.SpanTracer()
        n_probe = 20_000
        t = time.perf_counter()
        for _ in range(n_probe):
            with tracer.span("probe", n=1):
                pass
        span_us = (time.perf_counter() - t) / n_probe * 1e6
        probe = SLO.SloTracker()
        t = time.perf_counter()
        for _ in range(n_probe):
            probe.observe("mixed", YCSB_OPS, 1e-3)
        slo_us = (time.perf_counter() - t) / n_probe * 1e6
        rec["host_path"] = {
            "ops_a_step": YCSB_OPS, "windows_a_side": OBS_HOST_REPEATS,
            "ms_per_step_on": on_ms, "ms_per_step_off": off_ms,
            "obs_share": (on_ms - off_ms) / off_ms,
            "median_ms_per_step_on": med[True],
            "median_ms_per_step_off": med[False],
            "median_obs_share": (med[True] - med[False]) / med[False],
            "walls_s_on": walls[True], "walls_s_off": walls[False],
            "spans_a_step": spans_step, "span_us": span_us,
            "slo_observe_us": slo_us,
            "spans_and_slo_us_a_step": spans_step * span_us + slo_us}

        # (c) the plane's readings against the smoke's own counts
        dd = obs.delta(s0, s1)
        want = {k: c1[k] - c0[k] for k in c1}
        got = {k: dd.get(f"dsm.{k}", 0) for k in c1}
        if got != want:
            raise AssertionError(f"22b(c): dsm.* deltas {got} != "
                                 f"counter_snapshot deltas {want}")
        if s1["slo.mixed.ops_total"] - mixed0 \
                != OBS_HOST_REPEATS * OBS_AB_STEPS * YCSB_OPS:
            raise AssertionError(f"22b(c): slo.mixed "
                                 f"{s1['slo.mixed.ops_total']} after (b)")
        snap = reg.snapshot()
        launches = {k: snap[f"kernels.{k}_launches"] for k in PK.LAUNCHES}
        if launches != PK.LAUNCHES:
            raise AssertionError(f"22b(c): kernels collector {launches} "
                                 f"!= LAUNCHES {PK.LAUNCHES}")
        if snap["device.hbm_pool_bytes"] != pool.numel() * 4:
            raise AssertionError(f"22b(c): pool bytes "
                                 f"{snap['device.hbm_pool_bytes']}")
        odir = tempfile.mkdtemp(prefix="sherman_obs_")
        try:
            prom = os.path.join(odir, "metrics.prom")
            obs.write_prometheus(prom, reg)
            parsed = {}
            for ln in open(prom):
                if not ln.startswith("#"):
                    name, val = ln.rsplit(" ", 1)
                    parsed[name] = float(val)
            jl = os.path.join(odir, "snap.jsonl")
            obs.write_snapshot_jsonl(jl, reg)
            with open(jl) as f:
                line = json.loads(f.readline())["metrics"]
            if parsed["sherman_device_hbm_pool_bytes"] \
                    != snap["device.hbm_pool_bytes"] \
                    or line["device.hbm_pool_bytes"] \
                    != snap["device.hbm_pool_bytes"] \
                    or line["slo.mixed.ops_total"] \
                    != snap["slo.mixed.ops_total"]:
                raise AssertionError("22b(c): the exposition and the JSONL "
                                     "snapshot disagree with the registry")
            rec["readings"] = {
                "dsm_delta": got, "slo_read_ops": snap["slo.read.ops_total"],
                "slo_mixed_ops": snap["slo.mixed.ops_total"],
                "kernels_launches": launches,
                "hbm_pool_bytes": snap["device.hbm_pool_bytes"],
                "hbm_total_bytes": snap["device.hbm_total_bytes"],
                "cuda_allocated_bytes": snap.get("device.cuda_allocated_bytes"),
                "cuda_max_allocated_bytes": snap.get(
                    "device.cuda_max_allocated_bytes"),
                "cuda_reserved_bytes": snap.get("device.cuda_reserved_bytes"),
                "prometheus_samples": len(parsed),
                "jsonl_keys": len(line),
                "retraces": snap["device.retraces"],
                "ledger_programs": snap["device.programs"],
                "slo": {k: v for k, v in snap.items()
                        if k.startswith("slo.")}}

            # (d) traces: the tracer's Chrome trace of one YCSB-A step,
            # and the torch profiler's of one staged YCSB-A step
            tr = obs.get_tracer()
            tr.reset()
            eng.mixed(*batches[0])
            cpath = tr.export_chrome(os.path.join(odir, "ycsb_a_step.json"))
            with open(cpath) as f:
                names = [e["name"] for e in json.load(f)["traceEvents"]]
            if "engine.mixed.descend_lock_apply" not in names:
                raise AssertionError(f"22b(d): the step's trace holds {names}")
            pdir = os.path.join(odir, "profile")
            with obs.device_trace(pdir):
                carry = mstep(pool, locks, counters, *staged_t, new_m())[2]
                mstep.drain(carry)
            (pname,) = os.listdir(pdir)
            with open(os.path.join(pdir, pname)) as f:
                kern = " ".join(e.get("name", "") for e in
                                json.load(f)["traceEvents"])
            named = [k for k in ("descent_round_kernel",
                                 "gather_pages_kernel", "writeback_kernel")
                     if k in kern]
            if dev.type == "cuda" and len(named) != 3:
                raise AssertionError(f"22b(d): the profiler's trace names "
                                     f"only {named}")
            rec["traces"] = {"chrome_events": len(names),
                             "chrome_spans": sorted(set(names)),
                             "profiler_kernels": named,
                             "profiler_trace_bytes": os.path.getsize(
                                 os.path.join(pdir, pname))}
        finally:
            shutil.rmtree(odir, ignore_errors=True)
    log.check(path, ("descent_round", "gather_pages", "writeback"))
    rec["flight"] = flight
    rec["ledger"] = {k: v for k, v in led.summary().items()
                     if k != "entries"}
    rec["launches"] = dict(log.launches)
    shapes = replay(log, path)
    rec["wall_s"] = time.perf_counter() - t_phase
    print(json.dumps(rec), flush=True)
    return shapes


# ---------------------------------------------------------------------------
# Phases 23-24: the hot-key leaf cache and the value heap.
# ---------------------------------------------------------------------------

TIER_KEYS = 3000                # the reference checks' tree (keys 100 + 3i)
CACHE_SLOTS = 65536             # SHERMAN_LEAF_CACHE=1
CACHE_AB_REPEATS = 3            # cached staged windows a side, interleaved
CACHE_AB_STEPS = 8
HEAP_KEYS = 2_000_000           # 24b's tree (phase 15's configuration)
HEAP_PAGES = 300_000            # heap pages a node (0.31 GB)
HEAP_VALUE_BYTES = 64
HEAP_AB_KEYS = 1_000_000        # the --ab arms' fresh trees
HEAP_DUR_PUTS = 8               # acked heap put batches after the base


def tiers_build(machine_nr: int, device: str, heap_pages: int = 0):
    """The reference checks' tree: keys ``100 + 3i`` for i below 3,000,
    values ``7 * key``, with the router; one node 2,048 pages and 256 rows,
    eight 1,024 pages and 128 rows a node (step capacity 256).
    -> (tree, eng, keys)."""
    from sherman_tpu_torch.cluster import Cluster
    from sherman_tpu_torch.config import DSMConfig
    from sherman_tpu_torch.models import batched
    from sherman_tpu_torch.models.btree import Tree
    N = machine_nr
    tree = Tree(Cluster(DSMConfig(
        machine_nr=N, pages_per_node=2048 if N == 1 else 1024,
        locks_per_node=512, step_capacity=512 if N == 1 else 256,
        chunk_pages=32, heap_pages_per_node=heap_pages, device=device)))
    eng = batched.BatchedEngine(tree, batch_per_node=256 if N == 1 else 128)
    keys = np.arange(100, 100 + 3 * TIER_KEYS, 3, dtype=np.uint64)
    batched.bulk_load(tree, keys, keys * np.uint64(7))
    eng.attach_router()
    return tree, eng, keys


def _pool_state(tree) -> list:
    d = tree.dsm
    return [t.to("cpu", copy=True) for t in (d.pool, d.locks, d.counters)]


def _cache_state(c) -> list:
    return ([a.copy() for a in c._table_host()] + [c._keys.copy()]
            + [c.stats(), dict(c._sidecar), dict(c._freq)]
            + ([t.to("cpu", copy=True) for t in c._dev]
               if c._dev is not None and not c._dirty else []))


def _cache_run(machine_nr: int, device: str) -> list:
    """Phase 23a's sequence on one device -> [(label, result)]: a 1,024-slot
    cache over the reference checks' tree; cached ``search`` against the
    same search uncached, ``search_combined`` of a duplicate-heavy batch,
    ``mixed`` (reads probe, writes invalidate), ``insert``, ``delete``,
    ``reclaim_empty_leaves`` (the unlink map's invalidation),
    auto-admission, a scrub quarantine and ``enter_degraded``'s flush,
    the sidecar; after each call the answers, the cache's mirror, stats
    and device tables, and the pool, locks and counters."""
    from sherman_tpu_torch import chaos as CH
    from sherman_tpu_torch.models.scrub import Scrubber
    tree, eng, keys = tiers_build(machine_nr, device)
    vals = keys * np.uint64(7)
    cache = eng.attach_leaf_cache(slots=1024)
    out = []

    def rec(label, res):
        out.append((label, [res, _cache_state(cache), _pool_state(tree)]))

    rec("fill", cache.fill(keys[:300]))
    rec("search", eng.search(keys[:600]))
    eng.leaf_cache = None
    uncached = eng.search(keys[:600])
    eng.leaf_cache = cache
    if not _same_obj(uncached, out[-1][1][0]):
        raise AssertionError(f"cache ({device}): cached search differs "
                             "from the uncached one")
    dup = np.concatenate([keys[:64], keys[700:760]] * 6)
    rec("search_combined", eng.search_combined(dup))
    mk = np.concatenate([keys[:100], keys[200:260]])
    mv = np.concatenate([np.zeros(100, np.uint64),
                         keys[200:260] ^ np.uint64(13)])
    isr = np.arange(160) < 100
    rec("mixed", eng.mixed(mk, mv, isr))
    rec("insert", eng.insert(keys[:10], keys[:10] * np.uint64(99)))
    rec("delete", eng.delete(keys[1000:1800]))
    rec("refill", cache.fill(keys[::5][:480]))
    rec("reclaim", eng.reclaim_empty_leaves())
    rec("search 2", eng.search(keys[::3]))
    eng.detach_leaf_cache()
    cache = eng.attach_leaf_cache(slots=512, admit_every=2)
    rng = np.random.default_rng(4)
    for i in range(4):
        rec(f"observe {i}", eng.search(keys[rng.integers(0, 300, 400)]))
    j = int(np.nonzero(cache._keys != 0)[0][0])
    victim = int(cache._addr[j])
    plan = CH.FaultPlan([{"kind": "flip_entry_ver", "step": 0,
                          "addr": victim, "slot": 2}])
    tree.dsm.install_chaos(plan)
    tree.dsm.read_word(0, 0)
    tree.dsm.install_chaos(None)
    scr = Scrubber(eng, interval=1)
    res = scr.scrub()
    rec("quarantine", (res["new_violations"], res["quarantined"],
                       res["degraded"]))
    rec("search 3", eng.search(keys[:300]))
    plan.undo(tree.dsm)
    scr.release_quarantine()
    if eng.degraded:        # the quarantine could not take the lock word
        eng.exit_degraded()
    cache.pin_payloads([int(k) for k in keys[:4]], [1, 2, 3, 4],
                       [b"a", b"b", None, b"d"])
    rec("sidecar", cache.payload_hits([int(k) for k in keys[:4]],
                                      [1, 2, 9, 4]))
    eng.enter_degraded("phase 23a: the flush")
    if cache.stats()["cached_keys"] or cache.stats()["sidecar_keys"]:
        raise AssertionError("cache: degraded entry left entries")
    rec("degraded", eng.search(keys[:50]))
    eng.exit_degraded()
    rec("stats", cache.stats())
    return out


def _heap_run(machine_nr: int, device: str, rdir: str) -> list:
    """Phase 24a's sequence on one device -> [(label, result)]: a value
    heap (256 pages a node; 48 on eight nodes) over the reference checks'
    tree with a 1,024-slot cache attached for the first gets; ``put`` of
    800 variable-length records, ``get`` with and without the cache,
    ``scan``, an overwrite, a class change, ``remove``, a double free,
    ``scrub`` with a leak and orphans, ``rebuild``; then a recovery plane:
    base, journaled puts and removes, a delta, a torn tail, the crash and
    ``recover``; after each call the answers, the heap region, the
    allocator and the pool, locks and counters."""
    from sherman_tpu_torch.errors import DoubleFreeError
    from sherman_tpu_torch.recovery import RecoveryPlane
    from sherman_tpu_torch.utils import journal as J
    tree, eng, keys = tiers_build(machine_nr, device,
                                  heap_pages=256 if machine_nr == 1 else 48)
    vh = eng.attach_value_heap()
    rng = np.random.default_rng(7)
    pay = [bytes(rng.integers(0, 256, int(n), dtype=np.uint8))
           for n in rng.integers(1, 250, 800)]
    out = []

    def heap_state(v):
        return [v.dsm.heap.to("cpu", copy=True), v._page_cls.copy(),
                v._ver.copy(), v._next_page.copy(), list(v._spare_pages),
                [(k, list(s)) for k, s in v._free.items()], v.stats(),
                v.dsm.heap_dirty_rows()]

    def rec(label, res, v=None, t=None):
        out.append((label, [res, heap_state(v or vh),
                            _pool_state(t or tree)]))

    rec("put", vh.put(keys[:800], pay))
    cache = eng.attach_leaf_cache(slots=1024)
    cache.fill(keys[:200])
    rec("get cached", vh.get(keys[:300]))
    eng.detach_leaf_cache()
    rec("get", vh.get(keys[:800]))
    if out[-1][1][0][0][:300] != out[-2][1][0][0]:
        raise AssertionError(f"heap ({device}): cached gets differ")
    rec("scan", vh.scan([(int(keys[100]), int(keys[160]))]))
    rec("overwrite", vh.put(keys[:50], [b"Z" * 40] * 50))
    rec("class change", vh.put(keys[50:80], [b"B" * 200] * 30))
    hv, _ = eng.search(keys[80:90])
    rec("remove", vh.remove(keys[80:90]))
    try:
        vh.free_handles(keys[80:90], hv)
        raise AssertionError("heap: a double free went through")
    except DoubleFreeError:
        pass
    row, slab = vh._alloc(0, 0, 1)[0]
    vh.dsm.heap_write_cells([row], [slab * 8], [(3 << 16) | 8])
    vh._ver[row, slab] = 3
    hv, _ = eng.search(keys[90:93])
    vh.free_handles(keys[90:93], hv)
    rec("scrub", vh.scrub(repair=True))
    rec("rebuild", vh.rebuild())
    plane = RecoveryPlane(tree.cluster, tree, eng, rdir)
    plane.checkpoint_base()
    rec("put journaled", vh.put(keys[100:160], [b"post-base"] * 60))
    rec("remove journaled", vh.remove(keys[160:170]))
    with np.load(plane.checkpoint_delta()["path"]) as z:
        rec("delta", [z["heap_rows"], z["heap_pages"]])
    rec("put after delta", vh.put(keys[170:200], [b"tail!"] * 30))
    # every key but the three orphans (freed behind the tree's back)
    rd = np.concatenate([keys[:90], keys[93:800]])
    want = vh.get(rd)
    seg = eng.journal.path
    plane.close()
    blob = open(seg, "rb").read()
    r = J.encode_record(J.J_DELETE, keys[:4])
    with open(seg, "ab") as f:
        f.write(r[:-2])
    del plane, vh, eng, tree, cache
    _, c2, t2, e2, receipt = RecoveryPlane.recover(
        rdir, device=device, batch_per_node=256 if machine_nr == 1 else 128)
    got = e2.value_heap.get(rd)
    if not _same_obj(got, want):
        raise AssertionError(f"heap ({device}): recovered gets differ "
                             "from the acked state (RPO > 0)")
    out.append(("journal", blob))
    out.append(("replay", receipt["replay"]))
    rec("recovered", got, e2.value_heap, t2)
    return out


def _tier_compare(what: str, machine_nr: int, devices, runs) -> int:
    a, b = runs
    if [x for x, _ in a] != [x for x, _ in b]:
        raise AssertionError(f"{what} reference: the runs differ in shape")
    for (label, x), (_, y) in zip(a, b):
        if not _same_obj(x, y):
            raise AssertionError(f"{what} reference ({machine_nr} "
                                 f"node(s)): {label} differs between "
                                 f"{devices[0]} and {devices[1]}: "
                                 f"{_diff(x, y)}")
    return len(a)


def cache_reference_check(machine_nr: int, devices=("cuda", "cpu")) -> None:
    """Phase 23a on ``machine_nr`` nodes: :func:`_cache_run` on the card
    and on the plain path on the CPU, every result bit-identical."""
    t = time.perf_counter()
    runs = [_cache_run(machine_nr, d) for d in devices]
    n = _tier_compare("cache", machine_nr, devices, runs)
    _log(f"23a cache reference check ({machine_nr} node(s), {TIER_KEYS:,} "
         f"keys, {devices[0]} vs {devices[1]}): answers, cache mirrors, "
         f"stats, device tables, pools and counters bit-identical ({n} "
         f"results; {time.perf_counter() - t:.1f} s)")


def heap_reference_check(machine_nr: int, devices=("cuda", "cpu")) -> None:
    """Phase 24a on ``machine_nr`` nodes: :func:`_heap_run` on the card
    and on the plain path on the CPU, every result, heap region and
    journal byte bit-identical, RPO 0 on both."""
    t = time.perf_counter()
    runs = []
    for d in devices:
        rdir = tempfile.mkdtemp(prefix="sherman_heap_ref_")
        try:
            runs.append(_heap_run(machine_nr, d, rdir))
        finally:
            shutil.rmtree(rdir, ignore_errors=True)
    n = _tier_compare("heap", machine_nr, devices, runs)
    _log(f"24a heap reference check ({machine_nr} node(s), {devices[0]} vs "
         f"{devices[1]}): payloads, handles, heap regions, allocators, "
         f"journal bytes, deltas and the recovered state bit-identical, "
         f"RPO 0 ({n} results; {time.perf_counter() - t:.1f} s)")


def cache_full_width(ctx: dict, smi: str, batch_c: int = 1 << 22) -> dict:
    """Phase 23b on phase 15's 100 M-key tree (``ctx``, after phase 22): a
    65,536-slot cache filled with the hottest ranks; the staged YCSB-C
    ``aligned`` step at ``batch_c`` clients with the cache on (residual
    cap ``dev_b_resid`` from two warm-up steps) and off, 3 windows of 8
    steps a side interleaved, the ledger sealed around each; receipts
    equal on both sides, the measured hit ratio beside
    ``expected_hit_ratio``, ms a step, the phase profile (with
    ``cache_probe``), host syncs a step; one host-path ``search_combined``
    of ``batch_c`` zipf keys with the cache equal to the same call
    without; the ``cache`` line; K1 and K2 replayed at every shape
    (path ``one_node_cache``).  -> {kernel: [shapes]}."""
    from sherman_tpu_torch import ycsb_bench as YB
    from sherman_tpu_torch.config import TreeConfig
    from sherman_tpu_torch.models import batched
    from sherman_tpu_torch.obs import device as DEV
    from sherman_tpu_torch.ops import bits
    from sherman_tpu_torch.workload import device_prep as DP
    from sherman_tpu_torch.workload.zipf import ZipfGen, expected_hit_ratio

    tree, eng = ctx["tree"], ctx["eng"]
    n_keys, dev = ctx["n_keys"], tree.dsm.pool.device
    salt, xor = YB.SALT, 0xD00D
    path = "one_node_cache"
    t_phase = time.perf_counter()
    led = DEV.get_ledger()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    eng_c = batched.BatchedEngine(tree, batch_per_node=batch_c,
                                  tcfg=TreeConfig(sibling_chase_budget=1))
    eng_c.router = eng.router
    pool, counters = tree.dsm.pool, tree.dsm.counters
    rec: dict = {"metric": "cache", "path": path, "card": smi,
                 "keys": n_keys, "batch": batch_c,
                 "windows_a_side": CACHE_AB_REPEATS,
                 "steps_a_window": CACHE_AB_STEPS, "reduced": []}
    with ShapeLog() as log:
        t = time.perf_counter()
        cache = eng_c.attach_leaf_cache(slots=CACHE_SLOTS)
        hot = bits.mix64_np(np.arange(cache.capacity, dtype=np.uint64)
                            ^ np.uint64(salt))
        fill = cache.fill(hot)
        rec["fill"] = {**fill, "s": time.perf_counter() - t,
                       "slots": cache.slots, "capacity": cache.capacity}
        mk = lambda **kw: DP.make_staged_step(
            eng_c, n_keys=n_keys, theta=0.99, salt=salt, batch=batch_c,
            sampler="analytic", fusion="aligned", check_xor=xor, **kw)
        step, (new_c, tb, rt, rk) = mk(dev_b=batch_c)
        c = _ints(step(pool, counters, tb, rt, rk, new_c())[1])
        dev_b = min(batch_c, -(-int(c[4] * 1.02) // 8192) * 8192 + 16384)
        staged_t = (tb, rt, rk)
        off, (new_off, *_) = mk(dev_b=dev_b, staged=staged_t)
        probe, (new_p, *_) = mk(dev_b=dev_b, staged=staged_t,
                                leaf_cache=cache)
        cp = new_p()
        for _ in range(2):
            cp = probe(pool, counters, *staged_t, cp)[1]
        cp = _ints(cp)
        resid = max(1, (cp[3] - cp[6] + 1) // 2)
        cap_r = min(dev_b, -(-int(resid * 1.05) // 8192) * 8192)
        on, (new_on, *_) = mk(dev_b=dev_b, staged=staged_t,
                              leaf_cache=cache, dev_b_resid=cap_r)
        rec.update(dev_b=dev_b, dev_b_resid=cap_r,
                   resid_rows_a_step=resid)

        def window(stp, new):
            carry = new()
            for _ in range(CACHE_AB_STEPS):
                carry = stp(pool, counters, *staged_t, carry)[1]
            return stp.drain(carry)

        window(on, new_on)                           # warm-up
        window(off, new_off)
        walls = {True: [], False: []}
        outs = {True: set(), False: set()}
        hits = hits_u = 0
        for side in _ab_order(CACHE_AB_REPEATS):
            stp, new = (on, new_on) if side else (off, new_off)
            r0 = led.retraces
            with led.sealed_scope():
                sync()
                t = time.perf_counter()
                carry = window(stp, new)
                sync()
                walls[side].append(time.perf_counter() - t)
            if led.retraces != r0:
                raise AssertionError(f"23b: {led.retraces - r0} retraces "
                                     "in a sealed window")
            c = _ints(carry)
            if c[1] != 1:
                raise AssertionError(f"23b: a cap overflowed ({c}, cache "
                                     f"{side})")
            outs[side].add(tuple(c[:5]))
            if side:
                hits += c[5]
                hits_u += c[6]
        if len(outs[True]) != 1 or outs[True] != outs[False]:
            raise AssertionError(f"23b: receipts differ with the cache on "
                                 f"and off: {outs}")
        # twice a side, in turns, the second kept: the first count of a
        # process can catch one sync inside torch itself
        syncs = {}
        for side, stp, new in ((True, on, new_on), (False, off, new_off),
                               (True, on, new_on), (False, off, new_off)):
            box = {"c": new()}
            syncs[side] = count_syncs(lambda: box.__setitem__("c", stp(
                pool, counters, *staged_t, box["c"])[1]))
        prof = {"on": on.phase_profile(pool, counters, *staged_t, reps=4)[0],
                "off": off.phase_profile(pool, counters, *staged_t,
                                         reps=4)[0]}
        ops = CACHE_AB_REPEATS * CACHE_AB_STEPS * batch_c
        on_ms = min(walls[True]) / CACHE_AB_STEPS * 1e3
        off_ms = min(walls[False]) / CACHE_AB_STEPS * 1e3
        rec["staged"] = {
            "receipts": list(outs[True].pop()), "sum_hits": hits,
            "sum_hits_uniq": hits_u, "client_ops": ops,
            "hit_ratio": hits / ops,
            "hit_ratio_pred": expected_hit_ratio(n_keys, 0.99,
                                                 fill["placed"]),
            "hit_ratio_pred_capacity": expected_hit_ratio(
                n_keys, 0.99, cache.capacity),
            "uniq_hits_a_step": hits_u / (CACHE_AB_REPEATS
                                          * CACHE_AB_STEPS),
            "ms_per_step_on": on_ms, "ms_per_step_off": off_ms,
            "cache_share": (on_ms - off_ms) / off_ms,
            "walls_s_on": walls[True], "walls_s_off": walls[False],
            "phase_ms": prof, "host_syncs_per_step_on": syncs[True],
            "host_syncs_per_step_off": syncs[False], "retraces": 0}
        # the host path: one search_combined with the cache and without
        q = bits.mix64_np(ZipfGen(n_keys, 0.99, seed=23).sample(batch_c)
                          .astype(np.uint64) ^ np.uint64(salt))
        h0 = cache.hits
        t = time.perf_counter()
        with_c = eng_c.search_combined(q)
        t_on = time.perf_counter() - t
        eng_c.leaf_cache = None
        t = time.perf_counter()
        without = eng_c.search_combined(q)
        t_off = time.perf_counter() - t
        eng_c.leaf_cache = cache
        if not _same_obj(list(with_c), list(without)):
            raise AssertionError("23b: search_combined with the cache "
                                 "differs from the same call without")
        rec["host_path"] = {"keys": batch_c, "found": int(with_c[1].sum()),
                            "unique_hits": cache.hits - h0,
                            "wall_s_on": t_on, "wall_s_off": t_off}
        rec["stats"] = cache.stats()
    log.check(path, ("descent_round", "gather_pages"))
    rec["launches"] = dict(log.launches)
    shapes = replay(log, path)
    eng_c.detach_leaf_cache()
    rec["wall_s"] = time.perf_counter() - t_phase
    print(json.dumps(rec), flush=True)
    _log(f"23b cache at full width: {rec['wall_s']:.1f} s")
    return shapes


class HeapReads:
    """Records every ``get``, ``scan`` and ``put`` of a value heap in call
    order, so the answers are checked after the timed steps (outside
    their wall): replaying the log, each read must return the bytes the
    puts before it left (the migration's record where none did)."""

    def __init__(self, vh, value_bytes: int):
        self.vh, self.vb = vh, value_bytes
        self.over: dict = {}
        self.log: list = []
        get, put, scan = vh.get, vh.put, vh.scan

        def get_(keys, **kw):
            res = get(keys, **kw)
            self.log.append(("get", np.array(keys, np.uint64), res))
            return res

        def put_(keys, payloads, **kw):
            self.log.append(("put", np.array(keys, np.uint64), payloads))
            return put(keys, payloads, **kw)

        def scan_(ranges):
            res = scan(ranges)
            self.log.append(("scan", None, res))
            return res

        vh.get, vh.put, vh.scan = get_, put_, scan_

    def close(self) -> None:
        del self.vh.get, self.vh.put, self.vh.scan

    def check(self) -> int:
        """-> answers checked; raises on the first wrong one."""
        from sherman_tpu_torch.workload.ycsb import payloads_of
        n = 0

        def want(keys):
            base = payloads_of(keys, self.vb)
            return [self.over.get(int(k), b) for k, b in zip(keys, base)]

        for kind, keys, res in self.log:
            if kind == "put":
                self.over.update(zip(keys.tolist(), res))
            elif kind == "get":
                got, found = res
                if not np.asarray(found).all() or got != want(keys):
                    raise AssertionError("24b: a heap get returned a "
                                         "wrong or missing payload")
                n += keys.size
            else:
                for ks, ps in res:
                    if ps != want(ks):
                        raise AssertionError("24b: a heap scan returned a "
                                             "wrong payload")
                    n += len(ps)
        self.log.clear()
        return n


def heap_durability(box: dict, device: str) -> dict:
    """The heap's checkpoint and recovery on a served heap tree: a base
    (the pool and the whole heap region), ``HEAP_DUR_PUTS`` acked put
    batches of 8,192 records (sizes changing batch to batch, so slabs
    change class) with a delta after half of them, a remove of 256 keys,
    the crash (everything dropped, device memory freed) and ``recover``;
    RPO 0 over every acked record and every get of a probe equal before
    and after.  ``box`` holds the tree's only references (``cluster``,
    ``tree``, ``eng``, ``keys``), so the crash frees it.  -> the record."""
    from sherman_tpu_torch.recovery import RecoveryPlane
    from sherman_tpu_torch.workload.ycsb import payloads_of
    t = time.perf_counter()
    cluster, tree, eng, keys = (box.pop(k) for k in ("cluster", "tree",
                                                      "eng", "keys"))
    vh = eng.value_heap
    rdir = tempfile.mkdtemp(prefix="sherman_heap_dur_")
    try:
        plane = RecoveryPlane(cluster, tree, eng, rdir)
        t1 = time.perf_counter()
        plane.checkpoint_base()
        dur = {"keys": int(keys.size),
               "heap_pages_per_node": cluster.cfg.heap_pages_per_node,
               "base_s": time.perf_counter() - t1,
               "base_bytes": sum(os.path.getsize(os.path.join(rdir, f))
                                 for f in os.listdir(rdir))}
        rng = np.random.default_rng(24)
        acked = {}
        t1 = time.perf_counter()
        for i in range(HEAP_DUR_PUTS):
            ks = keys[rng.integers(0, keys.size, YCSB_OPS)]
            ps = payloads_of(ks ^ np.uint64(i + 2), 1 + i * 31 % 250)
            vh.put(ks, ps)
            acked.update(zip(ks.tolist(), ps))
            if i == HEAP_DUR_PUTS // 2:
                t2 = time.perf_counter()
                d = plane.checkpoint_delta()
                dur["delta"] = {"pages": d["pages"], "bytes": d["bytes"],
                                "s": time.perf_counter() - t2}
        gone = keys[rng.integers(0, keys.size, 256)]
        vh.remove(gone)
        for k in np.unique(gone).tolist():
            acked[k] = None
        dur["acked_puts_s"] = time.perf_counter() - t1
        probe = np.concatenate([np.fromiter(acked, np.uint64),
                                keys[rng.integers(0, keys.size, 65536)]])
        before = vh.get(probe)
        plane.close()
        del plane, vh, eng, tree, cluster
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        _, c2, t2, e2, receipt = RecoveryPlane.recover(
            rdir, device=device, batch_per_node=YCSB_OPS)
        dur["recover_s"] = time.perf_counter() - t1
        dur["recover_receipt_ms"] = {k: receipt[k] for k in (
            "restore_ms", "replay_ms", "rebase_ms", "total_ms")}
        dur["replay"] = receipt["replay"]
        after = e2.value_heap.get(probe)
        want = list(acked.values())
        got = [p if f else None for p, f in zip(after[0][:len(want)],
                                                after[1][:len(want)])]
        lost = sum(g != w for g, w in zip(got, want))
        if lost or not _same_obj(list(before), list(after)):
            raise AssertionError(f"24b: RPO {lost} over {len(acked):,} "
                                 "acked heap records, or gets differ "
                                 "after the recovery")
        dur.update(acked_keys=len(acked), rpo=lost,
                   probe_keys=int(probe.size))
        del c2, t2, e2
    finally:
        shutil.rmtree(rdir, ignore_errors=True)
    dur["s"] = time.perf_counter() - t
    _log(f"24b heap checkpoint and recovery: {dur['s']:.1f} s, RPO "
         f"{dur['rpo']}")
    return dur


def heap_full_width(smi: str, n_keys: int = HEAP_KEYS,
                    heap_pages: int = HEAP_PAGES,
                    device: str = "cuda", t_smoke: float | None = None
                    ) -> dict:
    """Phase 24b: ``tools/ycsb_bench.py --value-bytes 64 --value-dist
    fixed`` on phase 15's configuration at ``n_keys`` keys with
    ``heap_pages`` heap pages: the build, the migration of every record
    out of line (its wall and rate), the A-F matrix through the heap
    (8,192 ops a step, 8 timed steps, C sealed), every get and scan
    answer checked, ``heap_phase_ms``, ``audit_ok``; the ``--ab`` YCSB-C
    arms (inline, heap 28 B and 252 B) on fresh trees of
    ``HEAP_AB_KEYS``; before them, on the same heap tree,
    :func:`heap_durability`; the ``ycsb_matrix_heap`` line; K1-K3
    replayed at every shape of the migration and the matrix (path
    ``one_node_heap``).  Past a projection of ``SMOKE_CUT_S`` for the
    smoke (from ``t_smoke``, :func:`budget_cuts`), ``n_keys`` is halved
    (listed in ``reduced``).  -> {kernel: [shapes]}."""
    from sherman_tpu_torch import ycsb_bench as YB
    from sherman_tpu_torch.recovery import RecoveryPlane
    from sherman_tpu_torch.workload.ycsb import YcsbGen, payloads_of
    path = "one_node_heap"
    t_phase = time.perf_counter()
    cut = [] if t_smoke is None else list(budget_cuts("24b",
                                                      t_smoke).values())
    if cut:
        # the heap pages stay: the durability puts below need their own
        # slabs whatever the key count
        n_keys //= 2
    rec: dict = {"metric": "ycsb_matrix_heap", "path": path, "card": smi,
                 "keys": n_keys, "batch": YCSB_OPS, "steps": YCSB_STEPS,
                 "value_bytes": HEAP_VALUE_BYTES, "value_dist": "fixed",
                 "heap_pages_per_node": heap_pages, "reduced": [
                     f"keys 100,000,000 -> {n_keys:,}, for the smoke's "
                     "time limit",
                     f"--ab arms at {HEAP_AB_KEYS:,} keys (fresh trees), "
                     "for the smoke's time limit"] + cut}
    t = time.perf_counter()
    cluster, tree, eng, keys = YB.build(
        n_keys, YCSB_OPS, 1, device, heap_pages=heap_pages,
        value_bytes=HEAP_VALUE_BYTES, migrate=False, log=_log)
    rec["build_s"] = time.perf_counter() - t
    vh = eng.value_heap
    with ShapeLog() as log:
        dt = YB.migrate_to_heap(vh, keys, YCSB_OPS, HEAP_VALUE_BYTES)
        rec["migration"] = {"s": dt, "records_s": keys.size / dt,
                            "stats": vh.stats()}
        _log(f"24b migration: {keys.size:,} records in {dt:.1f} s")
        reads = HeapReads(vh, HEAP_VALUE_BYTES)
        rows, checked = {}, 0
        try:
            for w in "ABCDEF":
                gen = YcsbGen(w, n_keys, theta=0.99, seed=17, salt=YB.SALT,
                              value_bytes=HEAP_VALUE_BYTES)
                rows[w] = YB.run_workload(eng, gen, ops=YCSB_OPS,
                                          steps=YCSB_STEPS, seal=(w == "C"),
                                          vh=vh)
                t = time.perf_counter()
                n = reads.check()
                rows[w]["answers_checked"] = n
                rows[w]["check_s"] = time.perf_counter() - t
                checked += n
                _log(f"YCSB-{w} heap: {rows[w]['ops_s']:,.0f} ops/s, "
                     f"{n:,} answers checked")
        finally:
            reads.close()
        if rows["C"]["retraces"]:
            raise AssertionError(f"24b: YCSB-C retraced "
                                 f"{rows['C']['retraces']} times sealed")
        rec["workloads"] = rows
        rec["answers_checked"] = checked
        rec["heap_phase_ms"] = YB.heap_phase_attribution(eng, vh, keys,
                                                         YCSB_OPS)
        rec["audit_ok"] = YB.audit_heap(eng, vh, keys)
        if not rec["audit_ok"]:
            raise AssertionError("24b: the heap audit failed")
        rec["heap"] = vh.stats()
    log.check(path, ("descent_round", "gather_pages", "writeback"))
    rec["launches"] = dict(log.launches)
    shapes = replay(log, path)
    box = {"cluster": cluster, "tree": tree, "eng": eng, "keys": keys}
    del reads, cluster, tree, eng, vh, keys
    rec["durability"] = heap_durability(box, device)
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    rec["ycsb_c_ab"] = YB.run_c_ab(HEAP_AB_KEYS, YCSB_OPS, YCSB_STEPS,
                                   device=device, log=_log)
    rec["ab_s"] = time.perf_counter() - t
    gc.collect()
    torch.cuda.empty_cache()
    rec["wall_s"] = time.perf_counter() - t_phase
    print(json.dumps(rec), flush=True)
    _log(f"24b heap at full width: {rec['wall_s']:.1f} s")
    return shapes



# ---------------------------------------------------------------------------
# Phase 25: the serving front door (make_ingress_step on host and device
# prep, serve.py, audit.py, serve_bench.py).
# ---------------------------------------------------------------------------

FRONT_KEYS = 20_000             # 25a's tree (numpy seed 42)
FRONT_RUNGS = (256, 1024, 4096)
FRONT_STAMP = np.uint64(0xD00D)
SERVE_KEYS = 100_000_000        # BENCHMARKS.md:130-133's configuration
SERVE_WIDTHS = "262144,1048576,4194304"
SERVE_REQ_OPS = 65_536
SERVE_SECS = 30.0               # (b); cut to 15 past the projection
SERVE_SECS_DEVICE = 30.0        # (c)'s second run; cut to 10 first
CRASH_SECS = 10.0               # (d); cut to 5 third


def front_build(machine_nr: int, device: str):
    """25a's tree: 20,000 distinct random keys below 2^63 (numpy seed 42),
    values ``key ^ 0xD00D``, a heap region, the router; one node 2,048
    pages and 256 rows, eight 512 pages and 32 rows a node (step capacity
    32).  -> (tree, eng, keys)."""
    from sherman_tpu_torch.cluster import Cluster
    from sherman_tpu_torch.config import DSMConfig
    from sherman_tpu_torch.models import batched
    from sherman_tpu_torch.models.btree import Tree
    N = machine_nr
    rng = np.random.default_rng(42)
    keys = np.unique(rng.integers(1, 1 << 63, FRONT_KEYS + 1000,
                                  dtype=np.uint64))[:FRONT_KEYS]
    tree = Tree(Cluster(DSMConfig(
        machine_nr=N, pages_per_node=2048 if N == 1 else 512,
        locks_per_node=512, step_capacity=1024 if N == 1 else 32,
        chunk_pages=32, heap_pages_per_node=256 if N == 1 else 64,
        device=device)))
    eng = batched.BatchedEngine(tree, batch_per_node=256 if N == 1 else 32)
    batched.bulk_load(tree, keys, keys ^ FRONT_STAMP)
    eng.attach_router()
    return tree, eng, keys


def _prep_outputs(eng, prep_fn, batch, width) -> list:
    """The device prep's six outputs for ``batch``, on the host, and the
    host path's staging of the same batch; they must be equal."""
    from sherman_tpu_torch.ops import bits
    n = batch.size
    kh, kl = bits.keys_to_pairs(batch)
    raw = [np.full(width, -1, np.int32) for _ in range(2)]
    raw[0][:n], raw[1][:n] = kh, kl
    r = eng.router
    with r._read_locked():
        rtable = eng._dev(np.array(r.table_np))
        shift = torch.tensor(int(r.shift), dtype=torch.int64,
                             device=eng.device)
    out = prep_fn(eng._dev(raw[0]), eng._dev(raw[1]), n, rtable, shift)
    dev = [t.cpu().numpy() for t in out[:5]] + [int(out[5])]
    uk, inv = np.unique(batch, return_inverse=True)
    U = uk.size
    host = [np.zeros(width, np.int32), np.zeros(width, np.int32),
            np.zeros(width, bool), None, np.zeros(width, np.int32), U]
    host[0][:U], host[1][:U] = bits.keys_to_pairs(uk)
    host[2][:U] = True
    host[3] = r.host_start(host[0], host[1])
    host[4][:n] = inv.reshape(-1)
    if not _same_obj(dev, host):
        raise AssertionError(f"device prep differs from the host staging "
                             f"at width {width}: {_diff(dev, host)}")
    return dev


def _front_run(machine_nr: int, device: str, rdir: str) -> list:
    """Phase 25a's sequence on one device -> [(label, result)]:

    - the ingress step on host and on device prep at each of three rungs
      against ``search_combined`` (partial, all-duplicate and full
      batches; after an insert storm, batches with its keys, whose stale
      seeds straggle; with a cache attached), the device prep's six
      outputs against the host staging;
    - a serial front-door sequence through ``ShermanServer`` with a
      journal and an ``Auditor``: reads, inserts with rids and a retried
      rid re-acked, deletes, a scan, a degraded entry shedding writes
      while reads serve, drain; a deadline shed on an admission-only
      server; then a value heap: payload inserts with rids, payload
      reads, a payload delete;

    after each, the answers, and the pool, locks and counters; at the
    end the journal segments' bytes, the dedup windows and the heap."""
    from sherman_tpu_torch import audit as AU
    from sherman_tpu_torch import serve as SV
    from sherman_tpu_torch.utils import journal as J
    from sherman_tpu_torch.workload import device_prep as TP
    tree, eng, keys = front_build(machine_nr, device)
    out = []

    def rec(label, res):
        out.append((label, [res, _pool_state(tree)]))

    rng = np.random.default_rng(42)
    steps = {}
    for w in FRONT_RUNGS:
        steps[w] = (TP.make_ingress_step(eng, width=w, prep_impl="host"),
                    TP.make_ingress_step(eng, width=w, prep_impl="device"),
                    TP.make_device_prep(eng, width=w))

    def ingress(label, batch, w, cache=None):
        h, d, prep_fn = steps[w]
        got = h(batch)
        for other in (d(batch), eng.search_combined(batch)):
            if not _same_obj(got, other):
                raise AssertionError(f"25a ingress {label} ({device}): "
                                     f"answers differ: {_diff(got, other)}")
        if cache is not None:
            c = TP.make_ingress_step(eng, width=w, leaf_cache=cache,
                                     prep_impl="device")
            if c.prep_impl != "host" or not _same_obj(c(batch), got):
                raise AssertionError(f"25a ingress {label} ({device}): "
                                     "the cached step differs")
        rec(f"ingress {label} W={w}",
            [got, _prep_outputs(eng, prep_fn, batch, w)])
        return got

    for w in FRONT_RUNGS:
        for name, b in (("partial", rng.choice(keys, w // 2 + 3)),
                        ("all_dup", np.full(w // 3, keys[17], np.uint64)),
                        ("full", rng.choice(keys, w)),
                        ("single", keys[5:6])):
            v, f = ingress(name, np.ascontiguousarray(b, np.uint64), w)
            if not (f.all() and np.array_equal(v, b ^ FRONT_STAMP)):
                raise AssertionError(f"25a ingress {name} W={w} "
                                     f"({device}): wrong answers")
    fresh = np.setdiff1d(keys[:4000] + np.uint64(1), keys)
    rec("storm", eng.insert(fresh, fresh ^ FRONT_STAMP))
    allk = np.concatenate([keys, fresh])
    for w in FRONT_RUNGS:
        b = np.concatenate([rng.choice(fresh, w // 2), rng.choice(keys, 7)])
        v, f = ingress("stragglers", b, w)
        if not (f.all() and np.array_equal(v, b ^ FRONT_STAMP)):
            raise AssertionError(f"25a stragglers W={w} ({device}): "
                                 "wrong answers")
    cache = eng.attach_leaf_cache(slots=1024)
    rec("cache fill", cache.fill(allk[:300]))
    for w in FRONT_RUNGS:
        hot = allk[: min(w // 4, 300)]
        ingress("cached", np.concatenate([hot, hot,
                                          rng.choice(allk, w // 4)]),
                w, cache=cache)
    rec("cache stats", cache.stats())
    eng.detach_leaf_cache()

    # -- the serial front-door sequence ---------------------------------
    targets = {c: 1e9 for c in SV.OP_CLASSES}
    jpath = os.path.join(rdir, "front.wal")
    journal = J.Journal(jpath, sync=True, group_commit_ms=1.0)
    aud = AU.Auditor(sample_mod=1, interval_s=60.0)
    aud.seed_initial(allk, allk ^ FRONT_STAMP)
    srv = SV.ShermanServer(eng, SV.ServeConfig(
        widths=(256, 1024), p99_targets_ms=targets, write_linger_ms=0.5),
        journal=journal, auditor=aud)
    try:
        srv.start(calib_keys=keys,
                  calib_writes=(keys[:64], keys[:64] ^ FRONT_STAMP),
                  calib_delete_keys=np.asarray([3], np.uint64))
        for i, n in enumerate((100, 700, 1, 256)):
            b = rng.choice(allk, n)
            rec(f"read {i}", srv.submit("read", b, tenant=f"t{i % 2}")
                .result(timeout=120))
        k = keys[:64]
        rec("insert rid 1", srv.submit("insert", k, k ^ np.uint64(0xA1),
                                       rid=1, tenant="w")
            .result(timeout=120))
        f = srv.submit("insert", k, k ^ np.uint64(0xA1), rid=1, tenant="w")
        rec("retry rid 1", [f.result(timeout=120), f.deduped])
        rec("insert rid 2", srv.submit("insert", k, k ^ np.uint64(0xB2),
                                       rid=2, tenant="w")
            .result(timeout=120))
        rec("read back", srv.submit("read", k).result(timeout=120))
        rec("delete rid 3", srv.submit("delete", keys[100:110], rid=3,
                                       tenant="w").result(timeout=120))
        f = srv.submit("delete", keys[100:110], rid=3, tenant="w")
        rec("retry rid 3", [f.result(timeout=120), f.deduped])
        lo, hi = np.sort(keys[200:202])
        rec("scan", srv.submit("scan", ranges=[(int(lo), int(hi) + 1)])
            .result(timeout=120))
        eng.enter_degraded("phase 25a")
        try:
            rec("degraded insert", _outcome(lambda: srv.submit(
                "insert", k, k, rid=4, tenant="w")))
            rec("degraded read", srv.submit("read", keys[300:340])
                .result(timeout=120))
        finally:
            eng.exit_degraded()
        srv.drain()
        st = srv.stats()
        rec("contract", [st["contract"], st["tenants"], st["rejects"],
                         st["acked_writes"], st["retraces"]])
        rec("window", [[(t, rid, list(e)) for rid, e in s.dedup.items()]
                       for t, s in srv._tenants.items()])
    finally:
        srv.stop()
        journal.close()
    res = aud.tick(drain_all=True)
    if aud.violations or not res["linearizable"]:
        raise AssertionError(f"25a ({device}): the auditor reports "
                             f"violations: {res['violations'][:3]}")
    rec("audit", [res["linearizable"], aud.rec.events])
    # a deadline shed, on an admission-only server (no dispatcher)
    adm = SV.ShermanServer(eng, SV.ServeConfig(widths=(256,),
                                               p99_targets_ms=targets))
    adm._running = True
    fut = adm.submit("read", keys[:8], deadline_ms=0.01, tenant="d")
    time.sleep(0.002)
    shed = adm._take(("read",), 256)
    rec("deadline", [shed, _outcome(lambda: fut.result(timeout=1)),
                     adm.deadline_shed])
    adm._running = False
    adm._fail_queued(RuntimeError("25a done"))

    # -- payloads through the value heap ----------------------------------
    vh = eng.attach_value_heap()
    jpath2 = os.path.join(rdir, "front-heap.wal")
    journal2 = J.Journal(jpath2, sync=True, group_commit_ms=1.0)
    srv = SV.ShermanServer(eng, SV.ServeConfig(
        widths=(256,), p99_targets_ms=targets, write_linger_ms=0.5,
        calib_steps=1, seal=False), journal=journal2)
    try:
        srv.start(calib_keys=keys)
        pk = keys[400:432]
        pays = [bytes([i % 251]) * (1 + (i * 37) % 200) for i in range(32)]
        rec("payload insert", srv.submit("insert", pk, payloads=pays,
                                         rid=10, tenant="h")
            .result(timeout=120))
        got, fnd = srv.submit("read", pk, resolve_payloads=True
                              ).result(timeout=120)
        if not (fnd.all() and got == pays):
            raise AssertionError(f"25a ({device}): payload reads differ")
        rec("payload read", [got, fnd])
        rec("payload delete", srv.submit("delete", pk[:4], rid=11,
                                         tenant="h").result(timeout=120))
        rec("heap", [vh.stats(), tree.dsm.heap.to("cpu", copy=True)])
    finally:
        srv.stop()
        journal2.close()
    with open(jpath, "rb") as fh:
        rec("journal bytes", fh.read())
    with open(jpath2, "rb") as fh:
        rec("heap journal bytes", fh.read())
    return out


def front_reference_check(machine_nr: int, devices=("cuda", "cpu")) -> None:
    """Phase 25a on ``machine_nr`` nodes: :func:`_front_run` on the card
    and on the plain path on the CPU, every result, pool, journal byte,
    dedup window and heap bit-identical, the auditor clean."""
    t = time.perf_counter()
    runs = []
    for d in devices:
        rdir = tempfile.mkdtemp(prefix="sherman_front_ref_")
        try:
            runs.append(_front_run(machine_nr, d, rdir))
        finally:
            shutil.rmtree(rdir, ignore_errors=True)
    n = _tier_compare("front door", machine_nr, devices, runs)
    _log(f"25a front-door reference check ({machine_nr} node(s), "
         f"{FRONT_KEYS:,} keys, {devices[0]} vs {devices[1]}): ingress "
         f"answers on both placements, device prep outputs, the serial "
         f"sequence's answers, pools, journal bytes, dedup windows and "
         f"heap bit-identical, audit clean ({n} results; "
         f"{time.perf_counter() - t:.1f} s)")


def _serve_args(secs: float, *extra, keys: int | None = None) -> "object":
    from sherman_tpu_torch import serve_bench as SB
    keys = SERVE_KEYS if keys is None else keys
    return SB.parse_args(["--keys", str(keys), "--widths", SERVE_WIDTHS,
                          "--req-ops", str(SERVE_REQ_OPS), "--secs",
                          str(secs), "--theta", "0.99", "--tenants", "3",
                          "--rho", "0.6", "--fusion", "pipelined",
                          "--write-frac", "0", "--group-commit-ms", "2",
                          *extra])


def dispatch_syncs(eng, widths, sample) -> dict:
    """Host syncs of one ``dispatch`` and of one ``complete`` at each rung
    on each placement (torch's sync debug mode; the port's serve reads a
    pending count back once per straggler round)."""
    from sherman_tpu_torch.workload import device_prep as TP
    out = {}
    for w in widths:
        kb = sample(w)
        for p in ("host", "device"):
            step = TP.make_ingress_step(eng, width=w, prep_impl=p)
            step(kb)                                   # warm
            h = [None]
            nd = count_syncs(lambda: h.__setitem__(0, step.dispatch(kb)))
            nc = count_syncs(lambda: step.complete(h[0]))
            out[f"{w}.{p}"] = {"dispatch": nd, "complete": nc}
    return out


def prep_ab(eng, widths, sample) -> dict:
    """``BENCHMARKS.md:199-215``'s placement A/B at each rung: one batch
    of 65,536-op requests coalesced to the rung through host and through
    device prep; answers equal; ``prep_profile`` ms of each placement and
    the closed-loop wall of a step (dispatch + complete, 3 steps)."""
    from sherman_tpu_torch.workload import device_prep as TP
    out = {}
    for w in widths:
        kb = np.concatenate([sample(SERVE_REQ_OPS)
                             for _ in range(w // SERVE_REQ_OPS)])
        row = {}
        ans = {}
        for p in ("host", "device"):
            step = TP.make_ingress_step(eng, width=w, prep_impl=p)
            ans[p] = step(kb)
            row[f"prep_{p}_ms"] = step.prep_profile(kb, reps=4)[
                f"prep_{p}_ms"]
            TP._sync(eng.device)
            t = time.perf_counter()
            for _ in range(3):
                step(kb)
            row[f"step_{p}_ms"] = (time.perf_counter() - t) / 3 * 1e3
        row["answers_equal"] = _same_obj(ans["host"], ans["device"])
        if not row["answers_equal"]:
            raise AssertionError(f"25c W={w}: host and device prep answer "
                                 "differently")
        row["all_found"] = bool(ans["host"][1].all())
        out[str(w)] = row
        _log(f"25c W={w}: prep host {row['prep_host_ms']:.3f} ms, device "
             f"{row['prep_device_ms']:.3f} ms; step host "
             f"{row['step_host_ms']:.1f} ms, device "
             f"{row['step_device_ms']:.1f} ms; answers equal")
    return out


def front_full_width(smi: str, t_smoke: float, device: str = "cuda") -> dict:
    """Phase 25b-d at the north star's size, ``tools/serve_bench.py``'s
    configuration of ``BENCHMARKS.md:126-136``:

    - (b) the open-loop serve at 100,000,000 keys, widths 262,144 /
      1,048,576 / 4,194,304, 65,536-op requests, theta 0.99, 3 paced
      tenants and the greedy one, rho 0.6, ``pipelined``, reads only,
      group commit 2 ms; its ``serve_bench`` line, with the host syncs of
      one dispatch and one complete at each rung and placement;
    - (c) on (b)'s tree the prep placement A/B of ``BENCHMARKS.md:199-215``
      at each rung, then ``serve_bench`` again with
      ``SHERMAN_PREP_IMPL=device`` and an ``Auditor`` (sample_mod 8);
    - (d) ``run_crash_drill`` at 100,000,000 keys, 4 writers, group commit
      2 ms, 10 s: ``rpo_ops`` 0, ``acks_per_fsync`` above 1.

    (b)+(c) is the window ``one_node_serve``, (d) ``one_node_crash``; K1-K3
    replayed at every shape of each.  Past a projection of
    ``SMOKE_CUT_S`` for the smoke (:func:`budget_cuts`), (c)'s second run
    is cut to 10 s, then (b) to 15 s, then (d) to 5 s (listed in
    ``reduced``).  -> {kernel: [shapes]}."""
    from sherman_tpu_torch import audit as AU
    from sherman_tpu_torch import serve_bench as SB
    cuts = budget_cuts("25", t_smoke)
    reduced = list(cuts.values())
    secs_b = 15.0 if "b_secs" in cuts else SERVE_SECS
    secs_c = 10.0 if "c_secs" in cuts else SERVE_SECS_DEVICE
    secs_d = 5.0 if "d_secs" in cuts else CRASH_SECS
    n_keys = 10_000_000 if "keys" in cuts else SERVE_KEYS
    widths = tuple(int(w) for w in SERVE_WIDTHS.split(","))
    shapes: dict = {}
    t_phase = time.perf_counter()
    with ShapeLog() as log:
        t = time.perf_counter()
        SB.keyspace(n_keys)
        keys_s = time.perf_counter() - t
        built = SB.build_engine(n_keys, widths, False, device)
        build_s = time.perf_counter() - t
        _log(f"25b build: {n_keys:,} keys in {build_s:.1f} s (the "
             f"keyspace {keys_s:.1f} s)")
        t = time.perf_counter()
        rec_b = SB.run_serve(_serve_args(secs_b, "--device", device,
                                         keys=n_keys), built=built)
        rec_b["wall_s"] = time.perf_counter() - t
        eng, keys = built[2], built[3]
        sample = SB.make_sampler(n_keys, 0.99, built[4], 4242)
        rec_b["host_syncs"] = dispatch_syncs(eng, widths, sample)
        rec_b.update(card=smi, build_s=build_s, keyspace_s=keys_s,
                     reduced=[r for r in reduced if r.startswith("(b)")])
        print(json.dumps(rec_b), flush=True)
        _log(f"25b open-loop serve: {rec_b['serve_ops_s']:,} ops/s, read "
             f"p99 {rec_b['serve_read_p99_ms']} ms, retraces "
             f"{rec_b['serve']['retraces']}, bad values "
             f"{rec_b['serve']['bad_values']} ({rec_b['wall_s']:.1f} s)")
        if rec_b["serve"]["retraces"] or rec_b["serve"]["bad_values"]:
            raise AssertionError("25b: retraces or bad values in the "
                                 "open-loop serve")
        t = time.perf_counter()
        ab = prep_ab(eng, widths, sample)
        ab_s = time.perf_counter() - t
        old = os.environ.get("SHERMAN_PREP_IMPL")
        os.environ["SHERMAN_PREP_IMPL"] = "device"
        aud = AU.Auditor(sample_mod=8)
        try:
            t = time.perf_counter()
            rec_c = SB.run_serve(_serve_args(secs_c, "--device", device,
                                             keys=n_keys),
                                 built=built, auditor=aud)
            rec_c["wall_s"] = time.perf_counter() - t
        finally:
            if old is None:
                os.environ.pop("SHERMAN_PREP_IMPL", None)
            else:
                os.environ["SHERMAN_PREP_IMPL"] = old
        rec_c.update(card=smi, prep_ab=ab, prep_ab_s=ab_s,
                     reduced=[r for r in reduced if r.startswith("(c)")])
        rec_c["metric"] = "serve_bench_device_prep"
        print(json.dumps(rec_c), flush=True)
        audit = rec_c["serve"]["audit"]
        _log(f"25c device-prep serve: {rec_c['serve_ops_s']:,} ops/s, read "
             f"p99 {rec_c['serve_read_p99_ms']} ms, audit violations "
             f"{audit['violations']}, cost_frac {audit['cost_frac']:.4f} "
             f"({rec_c['wall_s']:.1f} s)")
        if audit["violations"] or rec_c["serve"]["retraces"] \
                or rec_c["serve"]["bad_values"]:
            raise AssertionError("25c: audit violations, retraces or bad "
                                 "values in the device-prep serve")
        del built, eng, keys, sample
    log.check("one_node_serve", ("descent_round", "gather_pages",
                                 "writeback"))
    for k, v in replay(log, "one_node_serve").items():
        shapes.setdefault(k, []).extend(v)
    del log
    gc.collect()
    torch.cuda.empty_cache()
    with ShapeLog() as log:
        t = time.perf_counter()
        rec_d = SB.run_crash_drill(_serve_args(secs_d, "--crash-drill",
                                               "--device", device,
                                               keys=n_keys))
        rec_d["wall_s"] = time.perf_counter() - t
    rec_d["card"] = smi
    rec_d["reduced"] = [r for r in reduced if r.startswith("(d)")]
    print(json.dumps(rec_d), flush=True)
    _log(f"25d crash drill: rpo_ops {rec_d['rpo_ops']}, acks/fsync "
         f"{rec_d['acks_per_fsync']}, replayed "
         f"{rec_d['replay']['records']} records ({rec_d['wall_s']:.1f} s)")
    if rec_d["rpo_ops"] or not (rec_d["acks_per_fsync"] or 0) > 1 \
            or not rec_d["ok"]:
        raise AssertionError(f"25d: the crash drill failed: {rec_d}")
    log.check("one_node_crash", ("descent_round", "gather_pages",
                                 "writeback"))
    for k, v in replay(log, "one_node_crash").items():
        shapes.setdefault(k, []).extend(v)
    del log
    gc.collect()
    torch.cuda.empty_cache()
    _log(f"25b-d front door at full width: "
         f"{time.perf_counter() - t_phase:.1f} s")
    return shapes


# ---------------------------------------------------------------------------
# Phase 26: the replication plane.
# ---------------------------------------------------------------------------

REPL_KEYS = 3000                # 26a's tree (the reference drills' keys)
FAILOVER_KEYS = 100_000_000     # 26b: BENCHMARKS.md:174-185's capture
FAILOVER_SECS = 30.0            # cut to 15 past the projection
PARTITION_KEYS = 10_000_000     # 26c: 100,000,000 -> 10,000,000
PARTITION_ROUNDS = 20


def _kind(fn):
    """-> ("ok", result) or ("raised", the error's class name): the
    replication plane's messages name chain ids, which are nonces."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the class is the outcome
        return ("raised", type(e).__name__)


def _repl_strip(x, cids=()):
    """A receipt without its wall times and chain ids."""
    if isinstance(x, str):
        for c in cids:
            if c:
                x = x.replace(c, "CID")
        return x
    if isinstance(x, dict):
        return {k: (None if k in ("promote_ms", "catchup_ms", "waited_ms",
                                  "quorum_wait_ms") else _repl_strip(v, cids))
                for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_repl_strip(v, cids) for v in x)
    return x


def _repl_state(group) -> list:
    """A group's observables: its counters (no wall times) and, a
    follower, the pool, the watermark file, the window and the tail."""
    st = dict(group.stats())
    st.pop("quorum_wait_ms")
    out = [st]
    for f in group.followers:
        with open(os.path.join(f.dir, "watermark.json")) as fh:
            wm = json.load(fh)
        if wm["cid"] != f.cid:
            raise AssertionError(f"follower {f.idx}: watermark {wm} names "
                                 f"another chain than {f.cid}")
        t = f.tailer
        out.append([f.cluster.dsm.pool.to("cpu", copy=True),
                    (wm["link"], wm["seq"]),
                    (f.link, f.seq, f.rebootstraps, f.caught_up,
                     f.quarantined, f.chaos_detected),
                    {k: [np.asarray(x) for x in v]
                     for k, v in f.window.items()},
                    dict(f.stats),
                    (None if t._cur is None else
                     os.path.basename(t._cur).replace(f.cid, "CID"),
                     t._off, t.seg_crc, t.torn_waits, t.stalls)])
    return out


def _repl_run(machine_nr: int, device: str, rdir: str) -> list:
    """Phase 26a's sequence on one device -> [(label, result)]: a primary
    of 3,000 keys with a recovery plane and a group of two followers
    (256-slot caches); shipped upserts, deletes and acks; a delta that
    sweeps the live segment and the re-bootstraps; replica reads served
    and forwarded; a ``ReplChaos.storm`` over the tail with its
    detections; quorum waits covered and timed out under a ship hold;
    an anti-entropy divergence repaired (full and sampled audits); a
    front door with rids; the split-brain fence point, the stale
    primary's fenced suffix and its typed refusal; the promotion,
    ``seed_dedup`` on the winner's front door and the retried rids; after
    each, the group's state (pools, watermarks, windows, tails, counters)
    and the primary's pool."""
    from sherman_tpu_torch import chaos as CH
    from sherman_tpu_torch import serve as SV
    from sherman_tpu_torch.failover_drill import (SALT, build_cluster,
                                                  drill_keyspace)
    from sherman_tpu_torch.models import batched
    from sherman_tpu_torch.recovery import RecoveryPlane
    from sherman_tpu_torch.replica import AntiEntropy, ReplicaGroup
    from sherman_tpu_torch.utils import journal as J
    N = machine_nr
    cluster, tree, eng = build_cluster(
        N, 1024 if N == 1 else 256, batch_per_node=128, device=device,
        locks_per_node=256, chunk_pages=32)
    keys = drill_keyspace(REPL_KEYS)
    vals = keys ^ np.uint64(SALT)
    batched.bulk_load(tree, keys, vals)
    eng.attach_router()
    plane = RecoveryPlane(cluster, tree, eng, os.path.join(rdir, "primary"))
    plane.checkpoint_base()
    group = ReplicaGroup(plane, 2, batch_per_node=128, cache_slots=256,
                         poll_ms=1e9)
    out = []

    def rec(label, res):
        out.append((label, [res, _repl_state(group), _pool_state(tree)]))

    rec("bootstrap", None)
    eng.insert(keys[:200], vals[:200] ^ np.uint64(0x11))
    eng.delete(keys[200:216])
    okv = np.asarray([True, False, True])
    eng.journal.append_acks([(7, "t", J.J_UPSERT, okv),
                             (8, "t", J.J_DELETE, okv)])
    rec("ship", group.pump())
    plane.checkpoint_delta()
    eng.insert(keys[216:300], vals[216:300] ^ np.uint64(0x12))
    rec("sweep", [group.pump(), [f.rebootstraps for f in group.followers]])
    if any(f.rebootstraps != 1 for f in group.followers):
        raise AssertionError(f"26a ({device}): the sweep did not "
                             "re-bootstrap every follower")
    for f in group.followers:
        f.admit(keys[:64])
    rec("reads", [group.read(keys[:64]), group.read(keys[100:140]),
                  group.reads_served, group.reads_forwarded])
    # a seeded storm over the shipping tail
    storm = CH.ReplChaos.storm(5, n_faults=6, poll_hi=16, span_hi=3,
                               followers=2)
    group.attach_chaos(storm)
    for i in range(8):
        k = keys[300 + 24 * i: 324 + 24 * i]
        eng.insert(k, k ^ np.uint64(0x13 + i))
        group.pump()
    for _ in range(40):
        group.pump()
        if storm.exhausted and all(f.caught_up for f in group.followers):
            break
    rec("storm", [storm.injected, storm.detected, storm.describe()])
    if not (storm.exhausted and storm.injected and storm.detected):
        raise AssertionError(f"26a ({device}): the storm {storm.describe()}"
                             f" injected {storm.injected}, detected "
                             f"{storm.detected}")
    # quorum waits: covered, then timed out under a ship hold
    hold = CH.ReplChaos([], seed=0)
    group.attach_chaos(hold)
    eng.insert(keys[500:540], vals[500:540] ^ np.uint64(0x21))
    rc = group.wait_quorum(2, timeout_s=60.0)
    hold.hold("ship")
    eng.insert(keys[540:560], vals[540:560] ^ np.uint64(0x22))
    timed_out = _kind(lambda: group.wait_quorum(1, timeout_s=0.05))
    hold.heal()
    rc2 = group.wait_quorum(2, timeout_s=60.0)
    rec("quorum", [rc["needed"], rc["covered"], timed_out, rc2["covered"],
                   group.quorum_acks, group.quorum_timeouts])
    if timed_out[1] != "QuorumTimeoutError":
        raise AssertionError(f"26a ({device}): a held quorum gave "
                             f"{timed_out}")
    # anti-entropy: a divergence found, the follower repaired
    victim = group.followers[1]
    rows = victim.cluster.dsm.pool.shape[0]
    victim.cluster.dsm.pool[rows // 3, 9] = 0x0BAD
    ae = AntiEntropy(group, period_s=0, sample_rows=0)
    r1 = ae.tick()
    sampled = AntiEntropy(group, period_s=0, sample_rows=16, seed=3)
    victim.cluster.dsm.pool[rows // 2, 11] = 0x0BAD
    verdicts = [sampled._pages_equal(victim, full=False) for _ in range(24)]
    victim.cluster.dsm.pool[rows // 2, 11] = \
        plane.cluster.dsm.pool[rows // 2, 11]
    rec("anti-entropy", [_repl_strip(r1), verdicts, ae.audits,
                         ae.divergences, ae.repairs, ae.unrepaired()])
    if not (ae.divergences == 1 and ae.repairs == 1
            and ae.unrepaired() == 0):
        raise AssertionError(f"26a ({device}): anti-entropy {r1}")
    # a front door with rids on the primary (its acks ride the journal)
    targets = {c: 1e9 for c in SV.OP_CLASSES}
    cfg = SV.ServeConfig(widths=(256,), p99_targets_ms=targets,
                         write_linger_ms=0.5, calib_steps=1, seal=False)
    srv = SV.ShermanServer(eng, cfg)
    acks = []
    try:
        srv.start(calib_keys=keys)
        for rid in (1, 2, 3):
            k = keys[600 + 16 * rid: 616 + 16 * rid]
            acks.append(srv.submit("insert", k, k ^ np.uint64(0x30 + rid),
                                   rid=rid, tenant="w").result(timeout=120))
        f = srv.submit("insert", keys[632:648],
                       keys[632:648] ^ np.uint64(0x32), rid=2, tenant="w")
        acks.append([f.result(timeout=120), f.deduped])
    finally:
        srv.stop()
    rec("front door", [acks, group.pump()])
    # the split-brain fence point and the stale primary's suffix
    lease = CH.ReplChaos([], seed=0)
    group.attach_chaos(lease)
    lease.hold("lease")
    eng.insert(keys[700:708], vals[700:708] ^ np.uint64(0x41))
    rcpt = group.promote()
    eng.insert(keys[708:716], vals[708:716] ^ np.uint64(0xFE))
    eng.insert(keys[716:724], vals[716:724] ^ np.uint64(0xFE))
    fenced_before = group.fenced_writes
    lease.heal()
    stale = _kind(lambda: eng.insert(keys[724:726], vals[724:726]))
    suffix = group.count_fenced_suffix()
    rec("fence", [_repl_strip(rcpt, (plane.cid,)), fenced_before, stale,
                  group.fenced_writes, suffix])
    if stale[1] != "StalePrimaryError" or suffix < 2 \
            or rcpt["fence"] is None:
        raise AssertionError(f"26a ({device}): fence {rcpt['fence']}, "
                             f"stale write {stale}, suffix {suffix}")
    # the winner's front door: seed_dedup, the retried rids re-acked
    win = group.promoted
    plane2 = RecoveryPlane(win.cluster, win.tree, win.eng,
                           os.path.join(rdir, "promoted"))
    plane2.checkpoint_base()
    srv2 = SV.ShermanServer(win.eng, cfg)
    try:
        srv2.start(calib_keys=keys)
        adopted = srv2.seed_dedup(group.promoted_window())
        retried = []
        for rid in (1, 3):
            k = keys[600 + 16 * rid: 616 + 16 * rid]
            f = srv2.submit("insert", k, k ^ np.uint64(0x30 + rid), rid=rid,
                            tenant="w")
            retried.append([f.result(timeout=120), f.deduped])
        back = srv2.submit("read", keys[600:720]).result(timeout=120)
    finally:
        srv2.stop()
        plane2.close()
    rec("resume", [adopted, retried, back, _pool_state(win.tree)])
    if not (adopted and all(d for _, d in retried)):
        raise AssertionError(f"26a ({device}): adopted {adopted}, retries "
                             f"deduped {[d for _, d in retried]}")
    group.close()
    plane.close()
    return out


def repl_reference_check(machine_nr: int, devices=("cuda", "cpu")) -> None:
    """Phase 26a on ``machine_nr`` nodes: :func:`_repl_run` on the card and
    on the plain path on the CPU, every result bit-identical."""
    t = time.perf_counter()
    runs = []
    for d in devices:
        rdir = tempfile.mkdtemp(prefix="sherman_repl_ref_")
        try:
            runs.append(_repl_run(machine_nr, d, rdir))
        finally:
            shutil.rmtree(rdir, ignore_errors=True)
    n = _tier_compare("replication", machine_nr, devices, runs)
    _log(f"26a replication reference check ({machine_nr} node(s), "
         f"{REPL_KEYS:,} keys, {devices[0]} vs {devices[1]}): pools, "
         f"watermarks, windows, tails, repl counters, the storm's "
         f"detections, quorum outcomes, anti-entropy verdicts, the fence "
         f"point, the suffix count and the retried rids bit-identical "
         f"({n} results; {time.perf_counter() - t:.1f} s)")


def repl_eight_node_drill(device: str = "cuda") -> dict:
    """Phase 26a's concurrent case: the failover drill at 5,000 keys on 8
    nodes (its writers, reader and replica reader launch from their own
    threads beside the front door's dispatcher and the group's pumps;
    the reference runs its drill on one node because concurrent
    multi-device XLA launches can deadlock their rendezvous, which the
    port's emulation does not have) with the drill's pins."""
    from sherman_tpu_torch import failover_drill as FD
    d = tempfile.mkdtemp(prefix="sherman_failover8_")
    t = time.perf_counter()
    try:
        rec = FD.run(_drill_args(FD, ["--keys", "5000", "--nodes", "8",
                                      "--secs", "1"], d, device))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    _boot_split(rec)
    _repl_pins("failover", rec, "26a")
    _log(f"26a failover drill on 8 nodes, 5,000 keys: pins held "
         f"({time.perf_counter() - t:.1f} s)")
    return rec


def _drill_args(mod, argv, d: str, device: str):
    return mod.parse_args(list(argv) + ["--dir", d, "--device", device])


def repl_full_width(smi: str, t_smoke: float, device: str = "cuda") -> dict:
    """Phase 26b-c:

    - (b) the failover drill (``failover_drill.py``) at 100,000,000 keys,
      one node, ``--replicas 2 --secs 30``, the reference's queued capture
      (``BENCHMARKS.md:174-185``); pins ``lost_acks == 0``,
      ``duplicate_acks == 0``, ``linearizable``, ``fenced_writes >= 1``
      and ``rebootstraps == 2``; with each bootstrap's seconds by part
      (the chain's inflate, the copy to the card, engine, router, cache)
      and the device memory;
    - (c) the partition drill (``partition_drill.py``) at 10,000,000 keys
      (``reduced``: 100,000,000 -> 10,000,000 for the time limit),
      ``--replicas 2 --seed 11 --rounds 20``; pins every scheduled fault
      fired and each kind of injection detected or refused,
      ``fenced_acks_merged == 0``, ``diverged_followers_unrepaired == 0``,
      ``lost_acks == 0``, ``duplicate_acks == 0``, ``linearizable``.

    (b) is the window ``one_node_failover``, (c) ``one_node_partition``;
    K1-K3 replayed at every shape of each.  Past a projection of
    ``SMOKE_CUT_S`` for the smoke (:func:`budget_cuts`), (b)'s traffic is
    cut to 15 s, then (c)'s keys to 1,000,000, then (b)'s keys to
    10,000,000 (each listed in ``reduced``).  -> {kernel: [shapes]}."""
    from sherman_tpu_torch import failover_drill as FD
    from sherman_tpu_torch import partition_drill as PD
    from sherman_tpu_torch.utils import checkpoint as CK
    shapes: dict = {}
    kern = ("descent_round", "gather_pages", "writeback")
    t_phase = time.perf_counter()
    cuts = budget_cuts("26", t_smoke)
    secs = 15.0 if "b_secs" in cuts else FAILOVER_SECS
    f_keys = 10_000_000 if "b_keys" in cuts else FAILOVER_KEYS
    p_keys = 1_000_000 if "c_keys" in cuts else PARTITION_KEYS
    reduced = [cuts[k] for k in ("b_secs", "b_keys") if k in cuts]
    p_cut = [f"keys 100,000,000 -> {PARTITION_KEYS:,}, for the smoke's "
             "time limit"] + [cuts[k] for k in ("c_keys",) if k in cuts]
    for name, mod, argv, cut, path in (
            ("failover", FD, ["--keys", str(f_keys), "--replicas",
                              "2", "--secs", str(secs)], reduced,
             "one_node_failover"),
            ("partition", PD, ["--keys", str(p_keys), "--replicas",
                               "2", "--seed", "11", "--rounds",
                               str(PARTITION_ROUNDS)], p_cut,
             "one_node_partition")):
        d = tempfile.mkdtemp(prefix=f"sherman_{name}_")
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        try:
            with ShapeLog() as log, Spans(CK, "_load_arrays") as sp:
                t = time.perf_counter()
                rec = mod.run(_drill_args(mod, argv, d, device))
                rec["wall_s"] = time.perf_counter() - t
        finally:
            shutil.rmtree(d, ignore_errors=True)
        rec.update(card=smi, reduced=cut, inflate_s=sp.s["_load_arrays"],
                   inflate_calls=sp.calls["_load_arrays"])
        _boot_split(rec)
        if device == "cuda":
            rec["device_bytes"] = dict(rec.get("device_bytes", {}),
                                       peak=torch.cuda.max_memory_allocated())
        try:
            _repl_pins(name, rec, "26b" if name == "failover" else "26c")
        finally:
            print(json.dumps(rec), flush=True)
        log.check(path, kern)
        for k, v in replay(log, path).items():
            shapes.setdefault(k, []).extend(v)
        del log, rec
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    _log(f"26b-c replication at full width: "
         f"{time.perf_counter() - t_phase:.1f} s")
    return shapes


def _boot_split(rec: dict) -> dict:
    """The drill's follower bootstraps summed by part, into the record."""
    boots = [b for f in rec["bootstrap_s"] for b in f]
    rec["bootstrap_split_s"] = {"bootstraps": len(boots),
                                **{k: sum(b[k] for b in boots)
                                   for k in boots[0]}}
    return rec["bootstrap_split_s"]


def _repl_pins(name: str, rec: dict, tag: str) -> None:
    """The drills' pins; a failed one fails the smoke."""
    bad = [k for k in ("lost_acks", "duplicate_acks") if rec[k] != 0]
    if not rec["linearizable"]:
        bad.append("linearizable")
    if name == "failover":
        if rec["fenced_writes"] < 1:
            bad.append("fenced_writes")
        if rec["repl"]["rebootstraps"] != 2:
            bad.append("rebootstraps")
        if rec["repl"]["read_failures"] or not rec["repl"]["reads_served"]:
            bad.append("replica reads")
        _log(f"{tag} failover drill at {rec['keys']:,} keys on "
             f"{rec['nodes']} node(s): lost_acks "
             f"{rec['lost_acks']}, duplicate_acks {rec['duplicate_acks']}, "
             f"linearizable {rec['linearizable']}, fenced "
             f"{rec['fenced_writes']}, rebootstraps "
             f"{rec['repl']['rebootstraps']}; lag {rec['repl']['lag_ms']} "
             f"ms, availability gap {rec['availability_gap_ms']} ms, "
             f"promote {rec['promote']['promote_ms']} ms; applied "
             f"{rec['repl']['applied_records']} records "
             f"({rec['repl']['applied_rows']} rows); replica reads served "
             f"{rec['repl']['reads_served']}, forwarded "
             f"{rec['repl']['reads_forwarded']}; bootstraps "
             f"{rec['bootstrap_split_s']}; device bytes "
             f"{rec.get('device_bytes')}; phases {rec['phase_s']} "
             f"({rec.get('wall_s', rec['elapsed_s']):.1f} s)")
    else:
        ch = rec["chaos"]
        detections = {
            "scheduled_windows_fired": all(f["fired"] for f in ch["faults"]),
            "reordered_views_refused": ch["detected"] >= 1,
            "ship_hold_quorum_typed": rec["quorum_timeout"]["typed"],
            "lease_hold_fenced_typed": rec["stale_rejected_typed"],
            "divergence_repaired": rec["anti_entropy"]["divergences"] >= 1}
        rec["detections"] = detections
        bad += [k for k, v in detections.items() if not v]
        bad += [k for k in ("fenced_acks_merged",
                            "diverged_followers_unrepaired") if rec[k] != 0]
        _log(f"{tag} partition drill at {rec['keys']:,} keys: "
             f"fenced_acks_merged {rec['fenced_acks_merged']}, unrepaired "
             f"{rec['diverged_followers_unrepaired']}, lost_acks "
             f"{rec['lost_acks']}, duplicate_acks {rec['duplicate_acks']}, "
             f"linearizable {rec['linearizable']}; quorum "
             f"{rec['quorum_latency']}; rejoin_catchup_ms "
             f"{rec['anti_entropy']['rejoin_catchup_ms']}; chaos injected "
             f"{ch['injected']}, detected {ch['detected']}; detections "
             f"{detections}; phases {rec['phase_s']} "
             f"({rec['wall_s']:.1f} s)")
    if bad:
        raise AssertionError(f"{tag}: the {name} drill failed its pins "
                             f"{bad}")


# ---------------------------------------------------------------------------
# Phase 27: elastic resize.
# ---------------------------------------------------------------------------

RESIZE_KEYS = 4000              # 27a: the reference drills' keys
RESIZE_BATCH = 16               # 27a's batch: more batches than rounds
RESIZE_CASES = ((1, 4), (4, 6))  # 27a's (source, target) node counts
RESIZE_SALT = 0xE1A57C
RESHARD_KEYS = 1_000_000        # 27b: 100,000,000 -> 1,000,000
RESHARD_BATCH = 32              # tools/reshard_drill.py's --batch-pages
CONTRACT_KEYS = 1_000_000       # 27c: 27b's key count
CONTRACT_SECS = 3.0             # 27c: the reference drill's default


def port_resize_mods(device: str):
    """The port's module handles for :func:`resize_run` on ``device``."""
    import types

    from sherman_tpu_torch import obs
    from sherman_tpu_torch.cluster import Cluster
    from sherman_tpu_torch.config import DSMConfig, TreeConfig
    from sherman_tpu_torch.migrate import Migrator
    from sherman_tpu_torch.models import batched
    from sherman_tpu_torch.models.btree import Tree
    from sherman_tpu_torch.recovery import RecoveryPlane
    from sherman_tpu_torch.utils import checkpoint as CK
    from sherman_tpu_torch.utils import journal as J
    from sherman_tpu_torch.utils import reshard as RS
    return types.SimpleNamespace(
        Cluster=Cluster, cfg=lambda **kw: DSMConfig(device=device, **kw),
        TreeConfig=TreeConfig, Tree=Tree, batched=batched, obs=obs,
        Migrator=Migrator, CK=CK, J=J, RS=RS,
        recover=lambda d, **kw: RecoveryPlane.recover(d, device=device,
                                                      **kw),
        plane=RecoveryPlane,
        restore=lambda path: CK.restore(path, device=device))


def _np(x) -> np.ndarray:
    """A host copy of a tensor or array of either package."""
    if isinstance(x, torch.Tensor):
        return x.to("cpu", copy=True).numpy()
    return np.array(x)


def _mig_counters(mig) -> list:
    return [mig.pages_moved, mig.batches, mig.retries, mig.lock_conflicts,
            mig.resume_count, mig.resume_verified, mig.recopies_clean,
            mig.seq, mig.staged_pages, len(mig._pending), sorted(mig._dirt)]


def _npz(path: str, drop=()) -> dict:
    with np.load(path) as z:
        return {k: np.asarray(z[k]) for k in z.files if k not in drop}


def _heap_alloc(vh) -> list:
    return [vh._page_cls.copy(), vh._ver.copy(), vh._next_page.copy(),
            list(vh._spare_pages),
            [(k, sorted(s)) for k, s in vh._free.items()]]


def resize_run(m, src: int, dst: int, heap: bool, rdir: str) -> list:
    """Phase 27a's sequence with one package's modules ``m`` -> [(label,
    result)], every result host numpy: a ``src``-node tree of the reference
    drills' 4,000 keys (with ``heap``, 540 payloads of keys no inline write
    touches, in a value heap of 256 pages in all) behind a recovery plane;
    ``Migrator.start`` toward ``dst`` nodes; six batches interleaved with
    acked inserts, deletes and heap puts; a delta whose clear the dirty
    sink rides; two more batches; a crash with a torn journal tail;
    ``recover`` and ``Migrator.resume``; more inserts, the copy to its end
    and ``finish``; then the emitted
    arrays, the batch artifacts by ``seq`` (the migration id, a nonce,
    taken out), the ``migrate.*`` counters and the dirt set at each step,
    the offline ``reshard`` of the final checkpoint (held equal to the
    emitted arrays), and the ``dst``-node restore: every answer, fresh
    inserts with splits, the pool, and with ``heap`` the rebuilt
    allocator and the payloads."""
    from sherman_tpu_torch.failover_drill import drill_keyspace
    pages = 1024
    kw = dict(pages_per_node=pages, locks_per_node=256, step_capacity=256,
              chunk_pages=32, heap_pages_per_node=256 // src if heap else 0)
    cl = m.Cluster(m.cfg(machine_nr=src, **kw))
    tree = m.Tree(cl)
    tcfg = m.TreeConfig(sibling_chase_budget=1)
    eng = m.batched.BatchedEngine(tree, batch_per_node=128, tcfg=tcfg)
    keys = drill_keyspace(RESIZE_KEYS)
    m.batched.bulk_load(tree, keys, keys ^ np.uint64(RESIZE_SALT))
    eng.attach_router()
    rng = np.random.default_rng(11)
    pay = [bytes(rng.integers(0, 256, int(n), dtype=np.uint8))
           for n in rng.integers(1, 250, 540)]
    hk = keys[3000:3540]        # the heap's keys: no inline write hits them
    vh = eng.attach_value_heap() if heap else None
    if heap:
        vh.put(hk[:400], pay[:400])
    rec_dir, mig_dir = os.path.join(rdir, "rec"), os.path.join(rdir, "mig")
    plane = m.plane(cl, tree, eng, rec_dir)
    plane.checkpoint_base()
    mig = m.Migrator(cl, tree, eng, dst, mig_dir,
                     target_pages_per_node=pages, batch_pages=RESIZE_BATCH)
    out = []
    info = mig.start()
    out.append(("start", [info["live_pages"], _mig_counters(mig)]))
    for r in range(6):
        res = mig.step()
        b = keys[r * 300: r * 300 + 200]
        st = eng.insert(b, b ^ np.uint64(0x1111 + r))
        if heap:
            vh.put(hk[400 + 20 * r: 420 + 20 * r],
                   pay[400 + 20 * r: 420 + 20 * r])
        out.append((f"batch {r}", [res, st["applied"], _mig_counters(mig)]))
    gone = eng.delete(keys[2000:2100])
    d = plane.checkpoint_delta()
    out.append(("delta", [_np(gone), d["pages"], _mig_counters(mig)]))
    for r in range(2):
        out.append((f"after delta {r}", [mig.step(), _mig_counters(mig)]))
    seg = eng.journal.path
    plane.close()
    mig.close()
    with open(seg, "ab") as f:  # a crash mid-append: half a record
        rec = m.J.encode_record(m.J.J_UPSERT,
                                np.asarray([1 << 40], np.uint64),
                                np.asarray([7], np.uint64))
        f.write(rec[: len(rec) // 2])
    del plane, mig, eng, tree, cl, vh
    plane, cl, tree, eng, rc = m.recover(rec_dir, batch_per_node=128,
                                         tcfg=tcfg)
    mig = m.Migrator.resume(cl, tree, eng, mig_dir,
                            batch_pages=RESIZE_BATCH)
    out.append(("resume", [rc["replay"]["records"], _mig_counters(mig)]))
    b = keys[2200:2600]
    st = eng.insert(b, b ^ np.uint64(0x3333))
    if heap:
        eng.value_heap.put(hk[520:], pay[520:])
    n = mig.run_to_copied()
    out.append(("copied", [st["applied"], n, _mig_counters(mig)]))
    online = os.path.join(rdir, "online.npz")
    summ = mig.finish(online)
    out.append(("finish", [{k: v for k, v in summ.items()
                            if k not in ("mid", "cutover_ms",
                                         "cutover_parts_ms", "dst")},
                           _mig_counters(mig)]))
    emitted = _npz(online)
    out.append(("emitted", emitted))
    arts = {}
    for path in glob.glob(os.path.join(mig_dir, "migbatch-*.npz")):
        z = _npz(path, drop=("mid", "integrity"))
        arts[int(z["seq"][0])] = z
    out.append(("artifacts", [arts[k] for k in sorted(arts)]))
    final = os.path.join(rdir, "final.npz")
    m.CK.checkpoint(cl, final)
    offline = os.path.join(rdir, "offline.npz")
    summ_off = m.RS.reshard(final, offline, dst, pages_per_node=pages)
    off = _npz(offline)
    if off.keys() != emitted.keys() or not all(
            np.array_equal(off[k], emitted[k]) for k in off):
        raise AssertionError(f"27a {src}->{dst} heap={heap}: the online "
                             "cutover differs from the offline reshard")
    out.append(("offline", summ_off))
    plane.close()
    want_v, want_f = eng.search(keys)
    del plane, mig, eng, tree, cl
    c2 = m.restore(online)
    t2 = m.Tree(c2)
    e2 = m.batched.BatchedEngine(t2, batch_per_node=128, tcfg=tcfg)
    e2.attach_router()
    got = e2.search(keys)
    if not (np.array_equal(got[0], want_v)
            and np.array_equal(got[1], want_f)):
        raise AssertionError(f"27a {src}->{dst} heap={heap}: the restored "
                             "tree answers differently from the source")
    out.append(("restored search", [_np(x) for x in got]))
    if heap:
        vh2 = e2.attach_value_heap()
        rb = vh2.rebuild()
        out.append(("heap rebuild", [rb, _heap_alloc(vh2),
                                     vh2.get(hk)]))
    fresh = np.unique(np.random.default_rng(7).integers(
        1 << 57, 1 << 58, 700, dtype=np.uint64))[:600]
    st = e2.insert(fresh, fresh)
    out.append(("fresh inserts", [st["applied"], st.get("device_splits"),
                                  _np(e2.search(fresh)[1])]))
    out.append(("pool", [_np(x) for x in (c2.dsm.pool, c2.dsm.locks,
                                          c2.dsm.counters)]))
    return out


def resize_reference_check(devices=("cuda", "cpu"), cases=RESIZE_CASES,
                           replay_shapes: bool = True) -> None:
    """Phase 27a: :func:`resize_run` at 1->4 and 4->6 nodes, the heap off
    and on, on the card and on the plain path on the CPU, every result
    bit-identical; on the card every kernel shape the runs launched is
    replayed against its plain twin (exact; ``replay_shapes``, which needs
    ``main()``'s build of the earlier designs)."""
    n_shapes = 0
    for src, dst in cases:
        for heap in (False, True):
            t = time.perf_counter()
            runs = []
            for d in devices:
                rdir = tempfile.mkdtemp(prefix="sherman_resize_ref_")
                spy = replay_shapes and d == "cuda" and d == devices[0]
                try:
                    with (ShapeLog() if spy
                          else contextlib.nullcontext()) as log:
                        runs.append(resize_run(port_resize_mods(d), src,
                                               dst, heap, rdir))
                finally:
                    shutil.rmtree(rdir, ignore_errors=True)
                if spy:
                    log.check(f"27a {src}->{dst} heap={heap}",
                              ("gather_pages", "writeback", "exchange"))
                    n_shapes += sum(len(v) for v in replay(
                        log, "resize_reference").values())
            n = _tier_compare(f"resize {src}->{dst} heap={heap}", src,
                              devices, runs)
            _log(f"27a resize {src}->{dst} nodes, heap {heap} "
                 f"({RESIZE_KEYS:,} keys, {devices[0]} vs {devices[1]}): "
                 f"emitted arrays, artifacts by seq, migrate counters, the "
                 f"offline reshard and the restored tree bit-identical "
                 f"({n} results; {time.perf_counter() - t:.1f} s)")
    _log(f"27a: {n_shapes} kernel shapes replayed against their plain "
         f"twins (exact)")


def _resize_pins(name: str, rec: dict, tag: str) -> None:
    """The drills' pins; a failed one fails the smoke."""
    if name == "reshard":
        bad = [k for k in ("lost_acks", "rpo_ops") if rec[k] != 0]
        if rec["bit_identical"] is not True:
            bad.append("bit_identical")
        if rec["cutover"]["resume_verified"] <= 0:
            bad.append("resume_verified")
        b, c = rec["batch"], rec["cutover"]
        _log(f"{tag} reshard drill at {rec['keys']:,} keys, "
             f"{rec['nodes']} -> {rec['target_nodes']} nodes, batch "
             f"{rec['batch_pages']}: lost_acks {rec['lost_acks']}, rpo_ops "
             f"{rec['rpo_ops']}, bit_identical {rec['bit_identical']}, "
             f"resume_verified {c['resume_verified']}; pages_moved "
             f"{c['pages_moved']} / batches {c['batches']}; host steps a "
             f"batch {b.get('host_steps_mean')}, ms a batch "
             f"{b.get('ms_mean')} (p99 {b.get('ms_p99')}), ms a host step "
             f"{b.get('ms_per_host_step')}; read p99 before / during "
             f"{rec['slo']['read_p99_before_ms']} / "
             f"{rec['slo']['read_p99_during_ms']} ms; cutover_ms "
             f"{c['cutover_ms']} by part {c['cutover_parts_ms']}; device "
             f"peak {rec.get('device_bytes', {}).get('peak')}; phases "
             f"{rec['phase_s']} ({rec['wall_s']:.1f} s)")
    else:
        bad = [k for k in ("duplicate_acks", "lost_acks", "rpo_ops",
                           "retraces") if rec[k] != 0]
        if rec["linearizable"] is not True:
            bad.append("linearizable")
        mg = rec["migration"]
        _log(f"{tag} contract drill at {rec['keys']:,} keys, "
             f"{rec['nodes']} -> {rec['target_nodes']} nodes, --secs "
             f"{rec['secs']}: duplicate_acks {rec['duplicate_acks']}, "
             f"lost_acks {rec['lost_acks']}, linearizable "
             f"{rec['linearizable']}, retraces {rec['retraces']}; "
             f"migration {mg['pages_moved']} pages in {mg['batches']} "
             f"batches ({mg['batch']}), cutover {mg['cutover_ms']} ms "
             f"{mg['cutover_parts_ms']}; audit cost "
             f"{rec['phase_a']['audit_cost_frac']}; phases "
             f"{rec['phase_s']} ({rec['wall_s']:.1f} s)")
    if bad:
        raise AssertionError(f"{tag}: the {name} drill failed its pins "
                             f"{bad}")


def resize_full_width(smi: str, t_smoke: float | None = None,
                      device: str = "cuda") -> dict:
    """Phase 27b-c:

    - (b) the reshard drill (``reshard_drill.py``) at the reference's
      queued capture (``BENCHMARKS.md:111-125``: one node to four, the
      drill's mix, ``--batch-pages 32``) at 1,000,000 keys (``reduced``:
      100,000,000 -> 1,000,000: one host step a lock word puts the copy
      at live pages x one host step), cut to 100,000 keys after (c)'s cut
      past the projection; pins ``lost_acks == 0``,
      ``rpo_ops == 0``, ``bit_identical``, ``resume_verified > 0``;
    - (c) the contract drill (``contract_drill.py``) at its reference node
      counts (2 -> 3) and (b)'s key count, ``--secs 3``, cut to 100,000
      keys past a projection of ``SMOKE_CUT_S`` for the smoke (from
      ``t_smoke``, :func:`budget_cuts`; listed in ``reduced``); pins
      ``duplicate_acks``, ``lost_acks``, ``rpo_ops`` and ``retraces`` 0,
      ``linearizable``.

    (b) is the window ``one_node_reshard`` (K1-K4: the source is one node,
    the restored target four), (c) ``two_node_contract`` (K2-K4); each must
    show the cutover's certification gather (K2 over every live row) and
    every shape is replayed.  -> {kernel: [shapes]}."""
    from sherman_tpu_torch import contract_drill as CD
    from sherman_tpu_torch import reshard_drill as RD
    shapes: dict = {}
    t_phase = time.perf_counter()
    keys_cut = ("keys 100,000,000 -> 1,000,000: the migrator takes one host "
                "step a lock word, in the reference's order, so the copy and "
                "the cutover's re-stage after the resume are live pages x one "
                "host step; 100 M and 10 M keys do not fit the smoke's time "
                "limit")
    cuts = {} if t_smoke is None else budget_cuts("27", t_smoke)
    c_keys = 100_000 if "c_keys" in cuts else CONTRACT_KEYS
    r_keys = 100_000 if "b_keys" in cuts else RESHARD_KEYS
    for name, mod, argv, cut, path, kern in (
            ("reshard", RD, ["--keys", str(r_keys), "--nodes", "1",
                             "--target-nodes", "4", "--batch-pages",
                             str(RESHARD_BATCH)],
             [keys_cut] + [cuts[k] for k in ("b_keys",) if k in cuts],
             "one_node_reshard", tuple(KERNELS)),
            ("contract", CD, ["--keys", str(c_keys), "--nodes", "2",
                              "--target-nodes", "3", "--secs",
                              str(CONTRACT_SECS)],
             [keys_cut] + [cuts[k] for k in ("c_keys",) if k in cuts],
             "two_node_contract",
             ("gather_pages", "writeback", "exchange"))):
        d = tempfile.mkdtemp(prefix=f"sherman_{name}_")
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        try:
            with ShapeLog() as log:
                t = time.perf_counter()
                rec = mod.run(_drill_args(mod, argv, d, device))
                rec["wall_s"] = time.perf_counter() - t
        finally:
            shutil.rmtree(d, ignore_errors=True)
        rec.update(card=smi, reduced=cut)
        if device == "cuda":
            rec["device_bytes"] = dict(rec.get("device_bytes", {}),
                                       peak=torch.cuda.max_memory_allocated())
        try:
            _resize_pins(name, rec, "27b" if name == "reshard" else "27c")
        finally:
            print(json.dumps(rec), flush=True)
        log.check(path, kern)
        # the cutover's certification gather: K2 over every live row of
        # the source pool
        live = (rec["cutover"] if name == "reshard"
                else rec["migration"])["live_pages"]
        cert = [s for s in log.counts.get("gather_pages", {})
                if not s[2] and s[1] == live]
        if not cert:
            raise AssertionError(f"{path}: the certification gather (K2 "
                                 f"over the {live} live rows) was not "
                                 "launched")
        _log(f"{path}: the certification gather at {cert}")
        for k, v in replay(log, path).items():
            shapes.setdefault(k, []).extend(v)
        del log, rec
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    _log(f"27b-c resize at full width: {time.perf_counter() - t_phase:.1f} s")
    return shapes


# ---------------------------------------------------------------------------
# Phase 28: the multihost service plane and host failover.
# ---------------------------------------------------------------------------

HOST_KEYS = 4000                # 28a: the reference drills' keys
HOST_SALT = 0x30057FEB          # the drills' bulk-load stamp
HOST_LEASE_S = 0.5              # 28c: the reference drill's lease
MULTIHOST_KEYS = 100_000_000    # 28b: BENCHMARKS.md:225-237's capture
HOSTFAIL_KEYS = 100_000_000     # 28c: BENCHMARKS.md:252-266's capture


def host_mods(device: str):
    """The port's module handles for :func:`host_plane_run` and
    :func:`host_fail_run` on ``device``."""
    import types

    from sherman_tpu_torch import chaos as CH
    from sherman_tpu_torch import hostlease as HL
    from sherman_tpu_torch import multihost as MH
    from sherman_tpu_torch import obs
    from sherman_tpu_torch.cluster import Cluster
    from sherman_tpu_torch.config import DSMConfig, TreeConfig
    from sherman_tpu_torch.models import batched
    from sherman_tpu_torch.models.btree import Tree
    from sherman_tpu_torch.recovery import RecoveryPlane
    from sherman_tpu_torch.replica import JournalTailer, ReplicaGroup
    from sherman_tpu_torch.utils import journal as J
    return types.SimpleNamespace(
        Cluster=Cluster, cfg=lambda **kw: DSMConfig(device=device, **kw),
        TreeConfig=TreeConfig, Tree=Tree, batched=batched, obs=obs, J=J,
        MH=MH, HL=HL, CH=CH, plane=RecoveryPlane, Tailer=JournalTailer,
        Group=ReplicaGroup, dev={"device": device})


class _Done:
    """A served request's future (the ``ServeFuture`` surface)."""

    def __init__(self, res, deduped=False):
        self._res, self.deduped = res, deduped

    def done(self) -> bool:
        return True

    def result(self, timeout=None):
        return self._res


class SyncDoor:
    """A front door that serves each request on the caller's thread as it
    is submitted (the routed door's ``submit``/``stats`` surface, no
    dispatcher thread): reads through ``search``, writes through
    ``insert``/``delete`` with their journal records and, with a rid, an
    ack record and an exactly-once window; scans through
    ``range_query_many``."""

    def __init__(self, m, eng):
        self.m, self.eng = m, eng
        self.window: dict = {}
        self.admitted = self.acked = self.dedup_hits = 0

    def seed_dedup(self, window, rejournal: bool = True) -> int:
        for k, v in window.items():
            self.window[k] = v
        return len(window)

    def submit(self, op, keys=None, values=None, *, tenant="default",
               ranges=None, rid=None, deadline_ms=None):
        J = self.m.J
        if op == "scan":
            return _Done(self.eng.range_query_many(ranges))
        keys = np.ascontiguousarray(keys, np.uint64)
        self.admitted += int(keys.size)
        if op == "read":
            v, f = self.eng.search(keys)
            return _Done((np.asarray(v, np.uint64), np.asarray(f, bool)))
        if rid is not None and (tenant, rid) in self.window:
            self.dedup_hits += 1
            return _Done(np.asarray(self.window[(tenant, rid)][1]), True)
        if op == "insert":
            self.eng.insert(keys, np.ascontiguousarray(values, np.uint64))
            ok, kind = np.ones(keys.size, bool), J.J_UPSERT
        else:
            ok, kind = np.asarray(self.eng.delete(keys), bool), J.J_DELETE
        self.acked += int(keys.size)
        if rid is not None:
            self.eng.journal.append_acks([(rid, tenant, kind, ok)])
            self.window[(tenant, rid)] = (kind, ok)
        return _Done(ok)

    def stats(self) -> dict:
        jr = self.eng.journal
        return {"admitted_ops": self.admitted, "served_ops": self.admitted,
                "acked_writes": self.acked,
                "contract": {"dedup_hits": self.dedup_hits,
                             "cached_rids": len(self.window)},
                "journal": {"fsyncs": jr.fsyncs if jr else 0,
                            "appends": jr.appends if jr else 0}}


def _host_small(m, pages: int = 1024):
    cl = m.Cluster(m.cfg(machine_nr=1, pages_per_node=pages,
                         locks_per_node=256, step_capacity=256,
                         chunk_pages=32))
    tree = m.Tree(cl)
    eng = m.batched.BatchedEngine(
        tree, batch_per_node=128,
        tcfg=m.TreeConfig(sibling_chase_budget=1))
    return cl, tree, eng


def _roles(x, cids: dict):
    """``x`` with each chain id (a nonce) replaced by its role and every
    wall time (a ``*_ms`` key) taken out."""
    if isinstance(x, str):
        for role, c in cids.items():
            if c:
                x = x.replace(c, role)
        return x
    if isinstance(x, dict):
        return {_roles(k, cids): _roles(v, cids) for k, v in x.items()
                if not (isinstance(k, str) and k.endswith("_ms"))}
    if isinstance(x, (list, tuple)):
        return type(x)(_roles(v, cids) for v in x)
    return x


def _dir_state(rdir: str, cids: dict, blobs=("journal-",)) -> list:
    """The directory's names (chain ids by role) and the bytes of the
    files whose names start with ``blobs``."""
    out = []
    for n in sorted(os.listdir(rdir)):
        path = os.path.join(rdir, n)
        if not os.path.isfile(path):
            continue
        data = None
        if n.startswith(blobs):
            with open(path, "rb") as f:
                data = f.read()
        out.append((_roles(n, cids), data))
    return sorted(out, key=lambda x: x[0])


def _hostify(x):
    """Nested tensors and arrays as host numpy, containers as lists."""
    if isinstance(x, (torch.Tensor, np.ndarray)):
        return _np(x)
    if isinstance(x, (list, tuple)):
        return [_hostify(v) for v in x]
    return x


def _obs_delta(m, s0: dict, prefixes) -> dict:
    d = m.obs.delta(s0, m.obs.snapshot())
    return {k: d[k] for k in sorted(d) if k.startswith(prefixes)
            and not k.endswith("_ms")}


def host_plane_run(m, rdir: str) -> list:
    """Phase 28a's service-plane sequence with one package's modules ``m``
    -> [(label, result)], every result host numpy: two host contexts of the
    reference drills' 4,000 keys (one node each) with their recovery
    planes in one directory (``-h0-``/``-h1-``) behind one
    ``MultihostService`` of :class:`SyncDoor` s; routed inserts with rids,
    reads, deletes and a fan-out scan; a delta on both chains; more routed
    writes; host 0's tail torn and both contexts dropped;
    ``recover_union`` (receipt, answers, pools); host 0's re-base sweeping
    only ``-h0-``; the cross-host tail (a tailer and a replica group on
    host 0's namespace) over routed writes on the recovered engines; the
    ``multihost.*`` counters and the merged stats."""
    from sherman_tpu_torch.failover_drill import drill_keyspace
    s0 = m.obs.snapshot()
    keys = drill_keyspace(HOST_KEYS)
    router = m.MH.HostRouter(2)
    own = router.owner(keys)
    hk = [keys[own == h] for h in (0, 1)]
    ctx, cids, out = [], {}, []
    for h in (0, 1):
        cl, tree, eng = _host_small(m)
        m.batched.bulk_load(tree, hk[h], hk[h] ^ np.uint64(HOST_SALT))
        eng.attach_router()
        plane = m.plane(cl, tree, eng, rdir, host_id=h, hosts=2)
        plane.checkpoint_base()
        cids[f"C{h}"] = plane.cid
        ctx.append((cl, tree, eng, plane))
    svc = m.MH.MultihostService([SyncDoor(m, c[2]) for c in ctx], router,
                                planes=[c[3] for c in ctx])
    rng = np.random.default_rng(28)
    for r in range(6):
        b = np.unique(keys[rng.integers(0, keys.size, 96)])
        v = b ^ np.uint64(0x1000 + r)
        out.append((f"insert {r}", svc.submit("insert", b, v, rid=100 + r,
                                             tenant="w").result()))
        out.append((f"read {r}", svc.submit("read", b).result()))
    gone = keys[1000:1040]
    out.append(("delete", svc.submit("delete", gone, rid=200,
                                     tenant="w").result()))
    out.append(("retried rid", svc.submit("insert", keys[:4], keys[:4],
                                          rid=100, tenant="w").deduped))
    lo, hi = int(keys[100]), int(keys[160])
    out.append(("scan", svc.submit("scan",
                                   ranges=[(lo, hi), (1, 1 << 40)]).result()))
    out.append(("deltas", [c[3].checkpoint_delta()["pages"] for c in ctx]))
    b = keys[2000:2300]
    out.append(("insert after delta", svc.submit(
        "insert", b, b ^ np.uint64(0x2222), rid=300, tenant="w").result()))
    out.append(("frontiers", _roles([[os.path.basename(p), n] for p, n
                                     in svc.journal_frontiers()], cids)))
    out.append(("stats", _roles(svc.stats(), cids)))
    torn = ctx[0][2].journal.path
    for c in ctx:
        c[3].close()
    with open(torn, "ab") as f:  # a crash mid-append: half a record
        rec = m.J.encode_record(m.J.J_UPSERT,
                                np.asarray([1 << 40], np.uint64),
                                np.asarray([7], np.uint64), rid=0xDEAD)
        f.write(rec[: len(rec) // 2])
    out.append(("written", _dir_state(rdir, cids)))
    del ctx, svc, c
    rec_ctx, receipt = m.plane.recover_union(
        rdir, hosts=2, batch_per_node=128,
        tcfg=m.TreeConfig(sibling_chase_budget=1), **m.dev)
    cids.update({f"R{h}": rec_ctx[h][0].cid for h in (0, 1)})
    out.append(("recover_union", _roles(receipt, cids)))
    for h in (0, 1):
        eng = rec_ctx[h][3]
        out.append((f"host {h} answers",
                    [_np(x) for x in eng.search(hk[h])]))
        out.append((f"host {h} torn key", _np(eng.search(
            np.asarray([1 << 40], np.uint64))[1])))
        out.append((f"host {h} pool", [_np(x) for x in (
            rec_ctx[h][1].dsm.pool, rec_ctx[h][1].dsm.locks,
            rec_ctx[h][1].dsm.counters)]))
        out.append((f"host {h} window", sorted(rec_ctx[h][0].dedup_window)))
    h1 = {n: d for n, d in _dir_state(rdir, cids, blobs=("base-h1",
                                                          "delta-h1",
                                                          "journal-h1"))
          if "-h1" in n}
    rec_ctx[0][0].checkpoint_base()
    cids["S0"] = rec_ctx[0][0].cid
    after = _dir_state(rdir, cids, blobs=("base-h1", "delta-h1",
                                          "journal-h1"))
    if {n: d for n, d in after if "-h1" in n} != h1:
        raise AssertionError("28a: host 0's re-base touched host 1's chain")
    out.append(("rebased", [n for n, _ in after]))
    tailer = m.Tailer(rdir, rec_ctx[0][0].cid, host_id=0)
    group = m.Group(rec_ctx[0][0], 1, cache_slots=256, poll_ms=1e9)
    svc = m.MH.MultihostService([SyncDoor(m, c[3]) for c in rec_ctx],
                                router, planes=[c[0] for c in rec_ctx])
    b = keys[2400:2700]
    out.append(("tail writes", svc.submit("insert", b, b ^ np.uint64(0x77),
                                          rid=400, tenant="t").result()))
    recs = tailer.poll()
    out.append(("tailed", _hostify(recs)))
    group.pump()
    st = group.stats()
    out.append(("group", [st["applied_records"], st["applied_rows"],
                          group.primary_host]))
    fol = group.followers[0]
    out.append(("follower", [_np(fol.cluster.dsm.pool),
                             [_np(x) for x in fol.eng.search(b)]]))
    group.close()
    for c in rec_ctx:
        c[0].close()
    out.append(("counters", _obs_delta(m, s0, ("multihost.",))))
    return out


def host_fail_run(m, rdir: str) -> list:
    """Phase 28c's failover sequence with one package's modules ``m``,
    without threads -> [(label, result)]: two hosts' chains (one node each,
    the reference drills' 4,000 keys) behind a ``MultihostService`` of
    :class:`SyncDoor` s, the lease table (lease 0.5 s, expiry judged at
    explicit instants) and a ``HostFence`` a host; routed acked writes;
    host 0 frozen (``HostChaos``: the dispatch refused typed, its renewals
    stopped, an in-flight append pinning its view, a torn half-frame);
    detection; the fence point; the adoption (receipt, ownership log,
    epochs, the recovered pool, answers through the adopted door, the
    seeded window); the zombie's fenced suffix and its typed refusal on
    heal; the hand-back and the re-register; the ``hostfail.*``,
    ``multihost.*`` and ``chaos.host_*`` counters."""
    from sherman_tpu_torch.failover_drill import drill_keyspace
    s0 = m.obs.snapshot()
    keys = drill_keyspace(HOST_KEYS)
    router = m.MH.HostRouter(2)
    own = router.owner(keys)
    hk = [keys[own == h] for h in (0, 1)]
    hc = m.CH.HostChaos([], seed=7)
    table = m.HL.HostLeaseTable(rdir, 2, lease_s=HOST_LEASE_S, chaos=hc)
    ctx, cids, out, epochs = [], {}, [], {}
    for h in (0, 1):
        cl, tree, eng = _host_small(m)
        m.batched.bulk_load(tree, hk[h], hk[h] ^ np.uint64(HOST_SALT))
        eng.attach_router()
        plane = m.plane(cl, tree, eng, rdir, host_id=h, hosts=2)
        plane.checkpoint_base()
        cids[f"C{h}"] = plane.cid
        epochs[h] = table.register(h, hwm=plane.journal_frontier())
        m.HL.HostFence(table, h, epochs[h], chaos=hc).install(eng)
        ctx.append((cl, tree, eng, plane))
    out.append(("registered", [_roles({k: v for k, v in table.read(h).items()
                                       if k != "timestamp"}, cids)
                               for h in (0, 1)]))
    doors = [SyncDoor(m, c[2]) for c in ctx]
    svc = m.MH.MultihostService(doors, router, planes=[c[3] for c in ctx])
    svc.attach_chaos(hc)
    rng = np.random.default_rng(29)
    for r in range(4):
        b = np.unique(keys[rng.integers(0, keys.size, 96)])
        out.append((f"insert {r}", svc.submit(
            "insert", b, b ^ np.uint64(0x3000 + r), rid=500 + r,
            tenant="w").result()))
    out.append(("delete", svc.submit("delete", keys[3000:3030], rid=600,
                                     tenant="w").result()))
    # host 0 freezes: refused at the dispatch seam, renewals stopped, one
    # in-flight append pins its lease view, a torn half-frame
    hc.freeze(0)
    out.append(("frozen dispatch", _kind(lambda: svc.submit(
        "read", keys[:64]))))
    out.append(("frozen renew", [table.renew(0, epochs[0]),
                                 table.renew(1, epochs[1])]))
    eng0 = ctx[0][2]
    eng0.journal.append(m.J.J_UPSERT, np.asarray([1 << 58], np.uint64),
                        np.asarray([1], np.uint64))
    rec = m.J.encode_record(m.J.J_UPSERT, np.asarray([1 << 40], np.uint64),
                            np.asarray([7], np.uint64), rid=0xDEAD)
    with open(eng0.journal.path, "ab") as f:
        f.write(rec[: len(rec) // 2])
    failover = m.HL.HostFailover(rdir, table, 2, recover_kw=dict(
        batch_per_node=128, tcfg=m.TreeConfig(sibling_chase_budget=1),
        **m.dev))
    time.sleep(0.01)
    table.renew(1, epochs[1])
    t0 = table.read(0)["timestamp"]
    out.append(("detect", [failover.detect(now=t0 + HOST_LEASE_S / 2),
                           failover.detect(now=t0 + HOST_LEASE_S + 0.002),
                           table.probe(1, now=t0 + HOST_LEASE_S + 0.002)]))
    fp = failover.fence_point(0)
    out.append(("fence point", [_roles(os.path.basename(fp[0]), cids),
                                fp[1]]))
    adopted = {}

    def door(plane, cluster, tree, eng):
        adopted["door"] = SyncDoor(m, eng)
        return adopted["door"]

    r = failover.adopt(0, 1, door_factory=door, service=svc)
    plane0, cl0, _tree0, e0 = r["context"]
    cids["R0"] = plane0.cid
    out.append(("adoption", _roles({k: v for k, v in r.items()
                                    if k not in ("context", "server")},
                                   cids)))
    out.append(("adopted pool", [_np(x) for x in (
        cl0.dsm.pool, cl0.dsm.locks, cl0.dsm.counters)]))
    out.append(("window", sorted(plane0.dedup_window)))
    out.append(("ownership", [failover.log.load()["overlay"],
                              failover.log.load()["pending"],
                              [_roles(x, cids) for x in
                               failover.log.load()["records"]]]))
    out.append(("epochs", table.epochs()))
    out.append(("served after adoption", svc.submit("read", hk[0]).result()))
    out.append(("retried rid", [svc.submit("insert", keys[:4], keys[:4],
                                           rid=500, tenant="w").deduped]))
    # the zombie: its pinned view still says epoch 1
    hc.revive(0, zombie=True)
    zk = np.unique(hk[0][:24])
    for i in range(3):
        eng0.journal.append(m.J.J_UPSERT, zk, zk ^ np.uint64(0xFEFE00 + i),
                            rid=0xF0 + i)
    fence = (os.path.join(rdir, r["fence"]["segment"]), r["fence"]["size"])
    out.append(("fenced suffix", m.HL.count_fenced_suffix(fence)))
    hc.heal()
    out.append(("zombie on heal", _kind(lambda: eng0.journal.append(
        m.J.J_UPSERT, zk[:1], zk[:1]))))
    out.append(("fenced never merged", [_np(x) for x in e0.search(zk)]))
    out.append(("unadopted", failover.unadopted_dead_hosts(
        now=table.read(1)["timestamp"])))
    out.append(("register while adopted", _kind(lambda: table.register(0))))
    out.append(("handback", [failover.handback(0, router=router),
                             router.overlay, table.register(0),
                             _roles(failover.log.load()["records"][-1],
                                    cids)]))
    out.append(("stats", _roles(svc.stats(), cids)))
    # the ownership log's bytes name the fence's segment (a chain id): its
    # records are compared by role above
    out.append(("dir", _dir_state(rdir, cids)))
    for c in ctx:
        c[3].close()
    plane0.close()
    out.append(("counters", _obs_delta(m, s0, ("hostfail.", "multihost.",
                                               "chaos.host"))))
    return out


def host_reference_check(devices=("cuda", "cpu"),
                         replay_shapes: bool = True) -> None:
    """Phase 28a: :func:`host_plane_run` and :func:`host_fail_run` on the
    card and on the plain path on the CPU, every result bit-identical
    (chain ids compared by role); on the card every kernel shape the runs
    launched is replayed against its plain twin (exact;
    ``replay_shapes``, which needs ``main()``'s build of the earlier
    designs)."""
    n_shapes = 0
    for name, fn in (("service plane", host_plane_run),
                     ("host failover", host_fail_run)):
        t = time.perf_counter()
        runs = []
        for d in devices:
            rdir = tempfile.mkdtemp(prefix="sherman_host_ref_")
            spy = replay_shapes and d == "cuda" and d == devices[0]
            try:
                with (ShapeLog() if spy
                      else contextlib.nullcontext()) as log:
                    runs.append(fn(host_mods(d), rdir))
            finally:
                shutil.rmtree(rdir, ignore_errors=True)
            if spy:
                log.check(f"28a {name}", ("descent_round", "gather_pages",
                                          "writeback"))
                n_shapes += sum(len(v) for v in replay(
                    log, "host_reference").values())
        n = _tier_compare(f"28a {name}", 1, devices, runs)
        _log(f"28a {name} ({HOST_KEYS:,} keys, two hosts, {devices[0]} vs "
             f"{devices[1]}): answers, pools, artifact names and journal "
             f"bytes (chain ids by role), receipts, counters and merged "
             f"stats bit-identical ({n} results; "
             f"{time.perf_counter() - t:.1f} s)")
    _log(f"28a: {n_shapes} kernel shapes replayed against their plain "
         f"twins (exact)")


def _host_pins(name: str, rec: dict, tag: str) -> None:
    """The drills' pins; a failed one fails the smoke."""
    if name == "multihost":
        bad = [k for k in ("rpo_ops", "lost_acks") if rec[k] != 0]
        if rec["linearizable"] is not True:
            bad.append("linearizable")
        if rec["ack_bandwidth"]["speedup"] < 1.5:
            bad.append("ack_bandwidth.speedup")
        _log(f"{tag} multihost drill at {rec['keys']:,} keys, "
             f"{rec['hosts']} hosts: rpo_ops {rec['rpo_ops']} (superseded "
             f"by in-flight writes {rec['superseded_by_inflight']}), "
             f"lost_acks {rec['lost_acks']}, linearizable "
             f"{rec['linearizable']} over {rec['audit']['events']} events; "
             f"union {rec['union']['per_host_ms']} ms a host "
             f"({rec['union']['total_ms']} ms); tail lag "
             f"{rec['tail']['lag_ms']} ms, replica reads "
             f"{rec['tail']['reads_served']}; ack A/B speedup "
             f"{rec['ack_bandwidth']['speedup']} (per-host "
             f"{rec['ack_bandwidth']['perhost_acks_s']} vs shared "
             f"{rec['ack_bandwidth']['shared_acks_s']} acks/s); memory "
             f"{rec['memory']}; phases {rec['phase_s']} "
             f"({rec['wall_s']:.1f} s)")
    else:
        bad = [k for k in ("lost_acks", "duplicate_acks",
                           "fenced_acks_merged", "unadopted_dead_hosts")
               if rec[k] != 0]
        if rec["linearizable"] is not True:
            bad.append("linearizable")
        _log(f"{tag} hostfail drill at {rec['keys']:,} keys, lease "
             f"{rec['lease_s']} s: lost_acks {rec['lost_acks']}, "
             f"duplicate_acks {rec['duplicate_acks']}, fenced_acks_merged "
             f"{rec['fenced_acks_merged']} of {rec['fenced_acks']}, "
             f"unadopted {rec['unadopted_dead_hosts']}, linearizable "
             f"{rec['linearizable']}; detect_ms {rec['detect_ms']}, "
             f"adoption_ms {rec['adoption_ms']} (recover "
             f"{rec['adoption']['recover']}), availability_gap_ms "
             f"{rec['availability_gap_ms']}; memory {rec['memory']}; "
             f"phases {rec['phase_s']} ({rec['wall_s']:.1f} s)")
    if bad:
        raise AssertionError(f"{tag}: the {name} drill failed its pins "
                             f"{bad}")


def host_full_width(smi: str, t_smoke: float | None = None,
                    device: str = "cuda") -> dict:
    """Phase 28b-c:

    - (b) the multihost drill (``multihost_drill.py``), two hosts, at the
      reference's queued capture (``BENCHMARKS.md:225-237``: 100,000,000
      keys); pins ``rpo_ops == 0``, ``lost_acks == 0``, ``linearizable``
      and the ack-bandwidth speedup >= 1.5;
    - (c) the hostfail drill (``hostfail_drill.py``), two hosts, lease
      0.5 s, at 100,000,000 keys (``BENCHMARKS.md:252-266``); pins
      ``lost_acks``, ``duplicate_acks``, ``fenced_acks_merged`` and
      ``unadopted_dead_hosts`` 0 and ``linearizable``.

    Past a projection of ``SMOKE_CUT_S`` for the smoke (from ``t_smoke``,
    :func:`budget_cuts`) (c)'s keys are cut to 10,000,000, then (b)'s, then
    each to 1,000,000 (listed in ``reduced``).  (b) is the window
    ``two_host_multihost``, (c) ``two_host_hostfail`` (K1-K3 in each);
    every shape is replayed.  -> {kernel: [shapes]}."""
    from sherman_tpu_torch import hostfail_drill as HD
    from sherman_tpu_torch import multihost_drill as MD
    shapes: dict = {}
    kern = ("descent_round", "gather_pages", "writeback")
    t_phase = time.perf_counter()
    cuts = {} if t_smoke is None else budget_cuts("28", t_smoke)
    m_keys = (1_000_000 if "b_keys_1m" in cuts else 10_000_000
              if "b_keys" in cuts else MULTIHOST_KEYS)
    f_keys = (1_000_000 if "c_keys_1m" in cuts else 10_000_000
              if "c_keys" in cuts else HOSTFAIL_KEYS)
    for name, mod, argv, cut, path in (
            ("multihost", MD, ["--keys", str(m_keys)],
             [cuts[k] for k in ("b_keys", "b_keys_1m") if k in cuts],
             "two_host_multihost"),
            ("hostfail", HD, ["--keys", str(f_keys), "--lease-s",
                              str(HOST_LEASE_S)],
             [cuts[k] for k in ("c_keys", "c_keys_1m") if k in cuts],
             "two_host_hostfail")):
        d = tempfile.mkdtemp(prefix=f"sherman_{name}_")
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        try:
            with ShapeLog() as log:
                t = time.perf_counter()
                rec = mod.run(_drill_args(mod, argv, d, device))
                rec["wall_s"] = time.perf_counter() - t
        finally:
            shutil.rmtree(d, ignore_errors=True)
        rec.update(card=smi, reduced=cut)
        try:
            _host_pins(name, rec, "28b" if name == "multihost" else "28c")
        finally:
            print(json.dumps(rec), flush=True)
        log.check(path, kern)
        for k, v in replay(log, path).items():
            shapes.setdefault(k, []).extend(v)
        del log, rec
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    _log(f"28b-c hosts at full width: {time.perf_counter() - t_phase:.1f} s")
    return shapes


# ---------------------------------------------------------------------------
# Phase 29: the native host tier (sherman_tpu_torch/native: BatchPrep, the
# host Tree's local lock tier and index cache, the host-staged loops).
# ---------------------------------------------------------------------------

NATIVE_KEYS = 20_000            # 29a's tree (the synthetic keyspace)
NATIVE_BATCH = 4096             # 29a's client ops a batch
NATIVE_PREP_STEPS = 3           # 29a's BatchPrep-staged batches
NATIVE_CACHE_OPS = 300          # 29a's index-cache probes and inserts
NATIVE_LOCK_OPS = 64            # 29a's single-client lock sequence
NATIVE_SUS_STEPS = 16           # 29b's sustained steps (8 past the budget)
NATIVE_BATCHES = 4              # 29b's start-sorted staged batches
NATIVE_LAT_STEPS = 64           # 29b's latency spans (bench.py's 64 blocks)
NATIVE_THREADS, NATIVE_ITERS = 4, 40   # 29a's threaded lock counter


def native_run(device: str) -> list:
    """Phase 29a's sequence on ``device``, from one seed: a tree of
    ``NATIVE_KEYS`` synthetic keys (``bench.build``); ``BatchPrep``-staged
    batches through ``_get_search_fanout`` (``bench.HostStager``, every
    answer checked); a host ``Tree`` client with the index cache, probed
    twice, then ``NATIVE_CACHE_OPS`` fresh keys inserted (leaf splits,
    stale entries) and read back; a seeded single-client lock sequence of
    protected increments on pages outside the tree and a ``lock_bench``.
    -> [(label, result)]: answers, cache stats, ``btree.cache_*`` deltas,
    counter deltas, the pool, lock table and counters."""
    from sherman_tpu_torch import bench
    from sherman_tpu_torch import obs
    from sherman_tpu_torch.models.btree import Tree
    from sherman_tpu_torch.parallel import dsm as D
    b = bench.build(NATIVE_KEYS, NATIVE_BATCH, NATIVE_BATCH, device,
                    log=lambda m: None)
    eng, salt, cluster = b["eng_c"], b["salt"], b["cluster"]
    out = []
    dev_b, n_u0 = bench.size_host_dev_b(NATIVE_KEYS, 0.99, salt,
                                        NATIVE_BATCH)
    st = bench.HostStager(eng, NATIVE_KEYS, 0.99, salt, NATIVE_BATCH, dev_b)
    out.append(("sizing", (dev_b, n_u0)))
    for k in range(NATIVE_PREP_STEPS):
        buf = st.prep(k % 2, want_keys=True)
        d = st.upload(k % 2)
        res = st.serve(d)
        if int(st.wrong(d, res)):
            raise AssertionError(f"29a ({device}): a staged answer is wrong")
        out.append((f"prep {k}", [buf.n_uniq, buf.keys.copy()]
                    + [np.array(getattr(buf, f)) for f in st.FIELDS]))
        out.append((f"fanout {k}", [x.cpu().numpy() for x in res]))
    t = Tree(cluster)
    t.enable_index_cache(4096)
    rng = np.random.default_rng(29)
    keys, snap = b["vals"] ^ VAL_XOR, obs.snapshot()
    probe = keys[rng.choice(keys.size, NATIVE_CACHE_OPS, replace=False)]
    for p in range(2):
        got = [t.search(int(k)) for k in probe]
        if got != [int(k ^ VAL_XOR) for k in probe]:
            raise AssertionError(f"29a ({device}): a cached read is wrong")
        out.append((f"cache pass {p}", t.index_cache.stats()))
    fresh = keys_of(np.arange(NATIVE_KEYS, NATIVE_KEYS + NATIVE_CACHE_OPS),
                    salt)
    for k in fresh:
        t.insert(int(k), int(k ^ VAL_XOR))
    got = [t.search(int(k)) for k in np.concatenate([fresh, probe])]
    if got != [int(k ^ VAL_XOR) for k in np.concatenate([fresh, probe])]:
        raise AssertionError(f"29a ({device}): a read after the splits "
                             "is wrong")
    d = obs.delta(snap, obs.snapshot())
    out.append(("cache after splits", [t.index_cache.stats(), {
        k: d.get(k, 0) for k in ("btree.cache_hits", "btree.cache_misses",
                                 "btree.cache_invalidations",
                                 "btree.sibling_chases")}]))
    pages = [t.ctx.alloc.alloc() for _ in range(8)]
    c0 = cluster.dsm.counter_snapshot()
    for p in rng.integers(0, len(pages), NATIVE_LOCK_OPS):
        a = pages[int(p)]
        la = t._lock(a)
        v = t.dsm.read_word(a, 7)
        t._write_and_unlock([{"op": D.OP_WRITE, "addr": a, "woff": 7,
                              "nw": 1, "payload": np.array([v + 1],
                                                           np.int32)}], la)
    t.lock_bench(12345, loops=8)
    c1 = cluster.dsm.counter_snapshot()
    out.append(("lock sequence", [[t.dsm.read_word(a, 7) for a in pages],
                                  {k: c1[k] - c0[k] for k in c1}]))
    dsm = cluster.dsm
    out.append(("state", [x.cpu().numpy() for x in (dsm.pool, dsm.locks,
                                                     dsm.counters)]))
    return out


def native_lock_counter(device: str) -> dict:
    """Phase 29a's threaded counter (``tests/test_local_locks.py``):
    ``NATIVE_THREADS`` host ``Tree`` clients of one cluster increment one
    word under one lock word, ``NATIVE_ITERS`` times each.  The counter
    must be exact, and the local tier's hand-over must keep the global
    CAS and unlocks under half the ops.  -> the counts."""
    from sherman_tpu_torch.cluster import Cluster
    from sherman_tpu_torch.config import DSMConfig
    from sherman_tpu_torch.models.btree import Tree
    from sherman_tpu_torch.parallel import dsm as D
    cluster = Cluster(DSMConfig(machine_nr=1, pages_per_node=32,
                                locks_per_node=8, step_capacity=16,
                                chunk_pages=8, device=device))
    trees = [Tree(cluster) for _ in range(NATIVE_THREADS)]
    page = trees[0]._root_addr
    c0 = cluster.dsm.counter_snapshot()
    errs = []

    def worker(tree):
        try:
            for _ in range(NATIVE_ITERS):
                la = tree._lock(page)
                v = tree.dsm.read_word(page, 200)
                tree._write_and_unlock(
                    [{"op": D.OP_WRITE, "addr": page, "woff": 200, "nw": 1,
                      "payload": np.array([v + 1], np.int32)}], la)
        except Exception as e:
            errs.append(e)

    ts = [threading.Thread(target=worker, args=(t,)) for t in trees]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
        if t.is_alive():
            raise AssertionError("29a: a lock worker hung")
    if errs:
        raise errs[0]
    total = NATIVE_THREADS * NATIVE_ITERS
    c1 = cluster.dsm.counter_snapshot()
    rec = {"ops": total, "counter": trees[0].dsm.read_word(page, 200),
           "cas": c1["cas_ops"] - c0["cas_ops"],
           "unlocks": c1["write_word_ops"] - c0["write_word_ops"]}
    if rec["counter"] != total or not (rec["cas"] < total // 2
                                       and rec["unlocks"] < total // 2):
        raise AssertionError(f"29a threaded lock counter ({device}): {rec}")
    return rec


def native_reference_check(devices=("cuda", "cpu")) -> None:
    """Phase 29a: :func:`native_run` on the card and on the plain path on
    the CPU, every result bit-identical; then :func:`native_lock_counter`
    on the card."""
    t = time.perf_counter()
    runs = [native_run(d) for d in devices]
    n = _tier_compare("29a native", 1, devices, runs)
    rec = native_lock_counter(devices[0])
    _log(f"29a native tier ({NATIVE_KEYS:,} keys, {devices[0]} vs "
         f"{devices[1]}): staged answers, prep buffers, cache stats, "
         f"btree.cache_* deltas, lock counts, pools and counters "
         f"bit-identical ({n} results); threaded lock counter on "
         f"{devices[0]}: {json.dumps(rec)} ({time.perf_counter() - t:.1f} s)")


def native_full_width(ctx: dict, smi: str, t_smoke: float | None = None,
                      device: str = "cuda") -> dict:
    """Phase 29b-c on phase 3's 100 M-key tree, its values restored to
    ``key ^ 0xDEADBEEF`` (``restore_bulk_values``): the bench's host-staged
    half (``bench.host_staged``: three sizing passes, the warm-up with
    every answer checked on the host, ``NATIVE_SUS_STEPS`` host-staged
    sustained steps, ``NATIVE_BATCHES`` start-sorted batches, the latency
    phase of ``NATIVE_LAT_STEPS`` synced steps through the histogram,
    every answer checked on the card; the host per-op floor through the
    host ``Tree``), inside the window ``one_node_native``; its
    ``native_host`` JSON line; every launched shape replayed (29c).  Past
    a projection of ``SMOKE_CUT_S`` the sustained steps are halved.
    -> {kernel: [shapes]}."""
    from sherman_tpu_torch import bench
    cuts = {} if t_smoke is None else budget_cuts("29", t_smoke)
    steps = NATIVE_SUS_STEPS // 2 if "b_steps" in cuts else NATIVE_SUS_STEPS
    t = time.perf_counter()
    restore_bulk_values(ctx)
    ctx["updated_ranks"] = ctx["updated_ranks"][:0]
    restore_s = time.perf_counter() - t
    eng, salt, n_keys = ctx["eng_c"], ctx["salt"], ctx["n_keys"]
    batch = eng.total
    fk = keys_of(np.arange(bench.HOST_FLOOR_LOOPS), salt)
    t = time.perf_counter()
    with ShapeLog() as log:
        rec = bench.host_staged(eng, n_keys, 0.99, salt, batch, steps=steps,
                                n_batches=NATIVE_BATCHES,
                                lat_steps=NATIVE_LAT_STEPS, floor_keys=fk,
                                floor_vals=fk ^ VAL_XOR, log=_log)
    rec = {"metric": "native_host", "keys": n_keys, "batch": batch,
           **rec, "wall_s": time.perf_counter() - t,
           "restore_s": restore_s, "card": smi,
           "reduced": list(cuts.values())}
    print(json.dumps(rec), flush=True)
    log.check("one_node_native", ("descent_round",))
    shapes = replay(log, "one_node_native")
    _log(f"29b-c native host tier at full width: "
         f"{time.perf_counter() - t:.1f} s")
    return shapes


# ---------------------------------------------------------------------------
# Phase 30: the drivers (``python -m sherman_tpu_torch.<driver>``), each run
# once through its ``main()`` on the card.
# ---------------------------------------------------------------------------

def _run_tool(name: str, mod, argv: list, env: dict | None = None):
    """``mod.main(argv)`` with ``env`` set around it and its stdout kept
    (its last line is its receipt); its stderr passes through.
    -> (receipt, stdout lines, seconds)."""
    import io
    old = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    buf = io.StringIO()
    t = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            out = mod.main(argv)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out, buf.getvalue().splitlines(), time.perf_counter() - t


def _tool_pins(name: str, out: dict, lines: list) -> None:
    """Each driver's pins (the reference tests' and drills' own)."""
    bad = []
    if name.startswith("benchmark"):
        if not (out["peak_ops"] > 0 and len(out["windows"]) >= 3
                and out["latency_us"] and not out["preempted"]):
            bad.append("peak_ops > 0 over >= 3 windows with percentiles")
    elif name in ("tree_test", "write_test", "skiplist_test"):
        if not (out["ok"] and any(f"{name} PASS" in x for x in lines)):
            bad.append("PASS")
        if name == "write_test" and not (
                0 < out["write_amplification_b"] < 1024
                and out["host_path"] == 0):
            bad.append("write amplification below a page, host path 0")
    elif name == "chaos_drill":
        if not (out["ok"] and out["host_revoked"] >= 1
                and out["engine_revoked"] >= 1 and out["lock_timeouts"] == 4
                and out["scrub"]["violations"] >= 1
                and out["blackbox"]["ordered"]):
            bad.append("ok, revocations, lock_timeouts == 4, ordered box")
    elif name == "recovery_drill":
        if not (out["ok"] and out["rpo_ops"] == 0 and out["rto_ms"] > 0
                and out["journal"]["truncated_tails"] >= 1
                and out["repair"]["pages"] >= 1):
            bad.append("ok, rpo_ops == 0, torn tail, targeted repair")
    elif name == "latency_bench":
        if not all(r["ops_s"] > 0 and r["ol_samples"] > 0
                   for r in out["rows"]) or len(out["rows"]) != 4:
            bad.append("four widths with ops_s > 0 and open-loop samples")
    elif name == "profile_gather":
        ph = out["phases"]
        if set(ph) != {"descent_round", "snapshot_gather", "writeback_3w",
                       "writeback_5w"} or not out["kernel_on_card"] \
                or not all({"twin", "kernel"} <= set(v) for v in ph.values()):
            bad.append("four phases, kernel and twin each, on the card")
    elif name == "profile_insert":
        if not (out["insert_step_update_only"] > 0
                and out["search_step_same_width"] > 0):
            bad.append("insert and search steps timed")
    elif name == "profile_prep":
        if not (set(out["impls"]) == {"host", "device"}
                and out["combine"]["locks_saved"] > 0
                and 0 < out["combine"]["ratio"] <= 1):
            bad.append("both impls, combine ratio in (0, 1]")
    elif name == "profile_staged2":
        if not (out["fusion"] == "aligned" and out["n_programs"] == 3
                and set(out["phase_ms"]) == {"prep", "serve_fanout",
                                             "verify"}
                and set(out["modes"]) == {"aligned", "pipelined"}
                and out["serve_host_staged_ms"] > 0):
            bad.append("aligned anatomy, three programs, both modes")
    elif name == "device_report":
        led = out["device"]["ledger"]
        if not (out["retraces"] == 0 and led["retraces"] == 0
                and led["programs"] >= 3 and set(
                    out["device"]["rooflines"]["staged"])
                == {"prep", "serve_fanout", "verify"}):
            bad.append("0 retraces, three staged rooflines")
    if bad:
        raise AssertionError(f"30 {name}: pins {bad} failed: "
                             f"{json.dumps(out, default=str)[:2000]}")


def tools_full_width(smi: str, t_smoke: float | None = None,
                     device: str = "cuda") -> dict:
    """Phase 30: every driver of the port that the earlier phases do not
    run, once through its ``main()`` on the card (``--device`` as given),
    its pins held:

    - window ``1t`` (one node): ``benchmark 1 95 26 --theta 0.99`` for
      three 1-s windows, ``tree_test``, ``write_test``, ``skiplist_test``
      at their defaults, ``latency_bench`` at its default widths,
      ``profile_gather`` and ``profile_insert`` at their default 2,097,152
      rows, ``profile_prep``, ``profile_staged2 aligned`` (and ``chained``,
      whose refusal is pinned) and ``device_report`` live;
    - window ``8t`` (several nodes): ``benchmark 8 50 26`` (K4 at eight
      emulated nodes) for three 1-s windows, and the chaos and recovery
      drills at their defaults (4 nodes, 4,000 keys); K1 is not on a
      multi-node path (its descents gather through K2 and K4).

    Past a projection of ``SMOKE_CUT_S`` for the smoke (``budget_cuts``)
    it takes :data:`TOOLS_CUTS` in order, each listed in ``reduced``.
    Every launched (kernel, shape) is replayed.  -> {kernel: [shapes]}."""
    from sherman_tpu_torch import (benchmark, chaos_drill, device_report,
                                   latency_bench, profile_gather,
                                   profile_insert, profile_prep,
                                   profile_staged2, recovery_drill,
                                   skiplist_test, tree_test, write_test)
    from sherman_tpu_torch.errors import ConfigError
    cuts = {} if t_smoke is None else budget_cuts("30", t_smoke)
    reduced = list(cuts.values())
    dv = ["--device", device]
    rows = ["--rows", "524288", "--keys", "500000"] if "rows" in cuts else []
    staged_env = ({"KEYS": "1000000", "B": "1048576", "DEVB": "278528"}
                  if "staged_keys" in cuts else {})
    win = ["--secs", "3", "--window", "1", *dv]
    one = (
        ("benchmark_1_95_26", benchmark,
         ["1", "95", "26", "--theta", "0.99", *win], None),
        ("tree_test", tree_test, dv, None),
        ("write_test", write_test,
         (["--n", "50000"] if "write_n" in cuts else []) + dv, None),
        ("skiplist_test", skiplist_test, [], None),      # host only
        ("latency_bench", latency_bench,
         (["--keys", "1000000"] if "lat_keys" in cuts else []) + dv, None),
        ("profile_gather", profile_gather, rows + dv, None),
        ("profile_insert", profile_insert, rows + dv, None),
        ("profile_prep", profile_prep, dv, None),
        ("profile_staged2", profile_staged2, ["aligned", *dv], staged_env),
        ("device_report", device_report, dv, None))
    several = (
        ("benchmark_8_50_26", benchmark, ["8", "50", "26", *win], None),
        ("chaos_drill", chaos_drill, dv, None),
        ("recovery_drill", recovery_drill, dv, None))
    shapes: dict = {}
    secs, heads = {}, {}
    for path, runs, must in (
            ("1t", one, ("descent_round", "gather_pages", "writeback")),
            ("8t", several, ("gather_pages", "writeback", "exchange"))):
        with ShapeLog() as log:
            for name, mod, argv, env in runs:
                out, lines, dt = _run_tool(name, mod, argv, env)
                secs[name] = dt
                try:
                    _tool_pins(name, out, lines)
                finally:
                    heads[name] = out
                    _log(f"30 {name} ({dt:.1f} s): " + json.dumps(
                        out, default=str)[:3000])
        log.check(path, must)
        for k, v in replay(log, path).items():
            shapes.setdefault(k, []).extend(v)
        del log
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    # the refusal of the forms the port does not build
    try:
        _run_tool("profile_staged2", profile_staged2, ["chained"] + dv,
                  staged_env)
    except ConfigError as e:
        refused = str(e)
    else:
        raise AssertionError("30 profile_staged2 chained: not refused")
    _log("tools: " + json.dumps({
        "seconds": secs, "card": smi, "reduced": reduced,
        "staged2_chained_refused": refused,
        "benchmark": {n: {"windows": heads[n]["windows"],
                          "latency_us": heads[n]["latency_us"]}
                      for n in ("benchmark_1_95_26", "benchmark_8_50_26")},
        "profile_gather": heads["profile_gather"]["phases"],
        "latency_bench": [{k: r[k] for k in (
            "width", "pipe_ms", "span_p50_ms", "span_p99_ms", "ops_s",
            "p50_measured_ms", "p99_measured_ms")}
            for r in heads["latency_bench"]["rows"]]}))
    return shapes


# ---------------------------------------------------------------------------
# Phase 31: the process-spanning transport, two ranks sharing the card.
# ---------------------------------------------------------------------------

MR_SALT = 0x5E17AB1E5A17
MR_A_KEYS = 20_000              # 31a: 2 ranks x 4 nodes against 8 on the CPU
MR_A_CFG = dict(machine_nr=8, pages_per_node=1024, locks_per_node=512,
                step_capacity=512, host_step_capacity=16, chunk_pages=32)
MR_A_B = 256                    # 31a's rows a node
MR_KEYS = 100_000_000           # 31b: the north-star keyspace
MR_BATCH_C = 1 << 22            # 31b's YCSB-C batch (all 8 nodes)
MR_BATCH_A = 1 << 20            # 31b's YCSB-A batch
MR_CAP = 131_072                # phase 6's step capacity
MR_STEPS = 4
MR_STORM_LEAVES = 4096          # 31b's storm: 20 fresh keys into each
MR_SAMPLE = 1 << 20             # 31b: keys searched on the restored tree
MR_CUT_KEYS = 10_000_000
MR_FAIL_KEYS = 4000             # 31c's tree
MR_FAIL_CFG = dict(machine_nr=8, pages_per_node=256, locks_per_node=256,
                   step_capacity=64, host_step_capacity=16, chunk_pages=8)
MR_CACHE_SLOTS = 65_536         # 31b's hot-key tier (phase 23b's)
MR_CACHE_STEPS = 4              # 31b's cached steps after a warm-up one
MR_INGRESS_W = 65_536           # 31b's ingress width: the top rung
MR_INGRESS_BATCHES = 2          # 31b's ingress batches a prep
MR_HB_S = 5                     # 31c's death drill heartbeat timeout
MR_STALL_HB_S = 60              # a stalled rank's heartbeat stops too


def _mr_small(keeper, device: str = "cuda"):
    """31c's two-rank tree: 4,000 keys over 8 nodes."""
    from sherman_tpu_torch.cluster import Cluster
    from sherman_tpu_torch.config import DSMConfig
    from sherman_tpu_torch.models import batched
    from sherman_tpu_torch.models.btree import Tree
    cluster = Cluster(DSMConfig(device=device, **MR_FAIL_CFG), keeper=keeper)
    tree = Tree(cluster)
    keys = keys_of(np.arange(MR_FAIL_KEYS, dtype=np.uint64), MR_SALT)
    order = np.argsort(keys)
    batched.bulk_load(tree, keys[order], (keys ^ VAL_XOR)[order])
    return cluster, batched.BatchedEngine(tree, batch_per_node=64), keys


def _mr_verify(eng, keys) -> None:
    got, found = eng.search(keys)
    if not (found.all() and np.array_equal(got, keys ^ VAL_XOR)):
        raise AssertionError(f"{int((~found).sum())} keys missing or wrong")


def mr_parity_seq(cluster, keeper, d: str, device: str) -> tuple:
    """31a's sequence (``tests/test_multihost.py``'s engine worker and
    staged worker): bulk load, insert with device splits, search, delete,
    the device validator, ``mixed``, the collective checkpoint and its
    restore, three staged aligned and three staged mixed steps.  Run by two
    ranks on the card and by one process on the CPU.
    -> (results, [clusters whose state is compared])."""
    from sherman_tpu_torch.models import batched, validate
    from sherman_tpu_torch.models.btree import Tree
    from sherman_tpu_torch.utils import checkpoint as CK
    from sherman_tpu_torch.workload import device_prep as DP
    tree = Tree(cluster)
    eng = batched.BatchedEngine(tree, batch_per_node=MR_A_B)
    keys = keys_of(np.arange(MR_A_KEYS, dtype=np.uint64), MR_SALT)
    vals = keys ^ VAL_XOR
    order = np.argsort(keys[:15_000])
    batched.bulk_load(tree, keys[:15_000][order], vals[:15_000][order],
                      fill=0.8)
    eng.attach_router()
    st = eng.insert(keys[15_000:], vals[15_000:])
    if not st.get("device_splits"):
        raise AssertionError(f"31a: no device splits: {st}")
    got, found = eng.search(keys)
    dropped = keys[::10]
    fnd = eng.delete(dropped)
    dev = validate.check_structure_device(tree)
    kept = np.setdiff1d(keys, dropped)
    mk = kept[:512]
    is_read = np.arange(mk.size) % 2 == 0
    ov, fm, stt = eng.mixed(mk, mk ^ np.uint64(0xABC), is_read)
    ck = os.path.join(d, f"mr_a_{device}.npz")
    CK.checkpoint(cluster, ck)
    c2 = CK.restore(ck, device=device, keeper=keeper)
    e2 = batched.BatchedEngine(Tree(c2), batch_per_node=MR_A_B)
    e2.attach_router()
    got2, f2 = e2.search(kept)
    back = np.concatenate([dropped, mk])
    e2.insert(back, back ^ VAL_XOR)      # every key at its bulk value
    step, (new_carry, tb, rt, rk) = DP.make_staged_step(
        e2, n_keys=MR_A_KEYS, theta=0.99, salt=MR_SALT, batch=MR_A_B,
        dev_b=MR_A_B, log2_bins=16, fusion="aligned")
    carry = new_carry()
    for _ in range(3):
        _, carry = step(e2.dsm.pool, e2.dsm.counters, tb, rt, rk, carry)
    ro = step.receipts(step.drain(carry))
    mstep, (new_mc, mtb, mrt, mrk) = DP.make_staged_mixed_step(
        e2, n_keys=MR_A_KEYS, theta=0.99, salt=MR_SALT, batch=MR_A_B,
        read_ratio=0.5, dev_rb=MR_A_B // 2, dev_wb=MR_A_B // 2,
        log2_bins=16)
    mc = new_mc()
    for _ in range(3):
        _, _, mc = mstep(e2.dsm.pool, e2.dsm.locks, e2.dsm.counters, mtb,
                         mrt, mrk, mc)
    mx = mstep.receipts(mstep.drain(mc))
    want = 3 * MR_A_B * 8
    if ro[:3] != [3, 1, want] or mx[:4] != [3, 1, want // 2, want // 2]:
        raise AssertionError(f"31a receipts {ro} {mx}")
    res = {"stats": [st[k] for k in ("applied", "superseded", "host_path",
                                     "rounds", "device_splits")],
           "got": got, "found": found, "fnd": fnd,
           "dev": [dev[k] for k in sorted(dev)], "ov": ov, "fm": fm,
           "stt": stt, "got2": got2, "f2": f2, "ro": ro, "mx": mx}
    return res, [cluster, c2]


def _mr_state(clusters) -> dict:
    out = {}
    for i, c in enumerate(clusters):
        d = c.dsm
        out[f"pool{i}"] = d.pool.cpu().numpy()
        out[f"locks{i}"] = d.locks.cpu().numpy()
        out[f"counters{i}"] = d.counters_np()
    return out


def _mr_rank_a(keeper, rank: int, d: str) -> tuple:
    """31a in a rank: the sequence, its state dumped for the parent, and
    every K4 shape the rank launched replayed against the plain version;
    then :data:`MR_SEQS`, their states dumped too.  -> (record, the
    shape log of window ``2c`` so far)."""
    with ShapeLog() as log:
        res, clusters = mr_parity_seq(clusters_a(keeper), keeper, d, "cuda")
    log.check(f"31a rank {rank}", ("gather_pages", "writeback", "exchange"))
    np.savez(os.path.join(d, f"mr_a_r{rank}.npz"), **_mr_state(clusters),
             **{f"res_{k}": np.asarray(v) for k, v in res.items()})
    del clusters
    gc.collect()
    # every K4 layout shape the rank launched, against the plain version
    # (31b's window times them)
    from sherman_tpu_torch.parallel import transport_kernel as TK
    gen = torch.Generator(device="cuda").manual_seed(4)
    layouts = [s for s in log.counts.get("exchange", {})
               if s[0] == "layout"]
    for _, a, b, run in layouts:
        x = torch.randint(-2**31, 2**31 - 1, (a * b * run,), generator=gen,
                          dtype=torch.int32, device="cuda")
        _eq(TK.block_transpose(x, a, b), TK.block_transpose_ref(x, a, b),
            f"exchange layout [{a}, {b}, {run}] (31a)")
    log.args.clear()
    rec = {"a_launches": log.launches, "a_layout_shapes": len(layouts)}
    # the hot-key tier and the ingress step, window 2c
    with ShapeLog() as log_c:
        for name, seq, cfg in MR_SEQS:
            cl = seq_cluster(keeper, cfg, "cuda")
            res = seq(port_seq_mods("cuda"), cl, keeper)
            np.savez(os.path.join(d, f"mr_{name}_r{rank}.npz"),
                     **_mr_state([cl]),
                     **{f"res_{k}": np.asarray(v) for k, v in res.items()})
            del cl
    log_c.check(f"31a rank {rank} (cache, ingress)",
                ("gather_pages", "writeback", "exchange"))
    rec["a_seq_launches"] = log_c.launches
    return rec, log_c


def clusters_a(keeper, device: str = "cuda"):
    from sherman_tpu_torch.cluster import Cluster
    from sherman_tpu_torch.config import DSMConfig
    return Cluster(DSMConfig(device=device, **MR_A_CFG), keeper=keeper)


def seq_cluster(keeper, cfg: dict, device: str):
    """A cluster of eight nodes for one of :data:`MR_SEQS`."""
    from sherman_tpu_torch.cluster import Cluster
    from sherman_tpu_torch.config import DSMConfig
    return Cluster(DSMConfig(device=device, machine_nr=8, **cfg),
                   keeper=keeper)


def _join_logs(a: "ShapeLog", b: "ShapeLog") -> "ShapeLog":
    """Two closed segments of one window as one log: launches and counts
    by shape summed, each shape's first kept launch (a K3 launch that
    applied a row over one that applied none)."""
    for k, by in b.counts.items():
        mine = a.counts.setdefault(k, {})
        for shape, n in by.items():
            mine[shape] = mine.get(shape, 0) + n
    for k, by in b.args.items():
        mine = a.args.setdefault(k, {})
        for shape, v in by.items():
            if shape not in mine or (shape in a._idle
                                     and shape not in b._idle):
                mine[shape] = v
                a._idle.discard(shape)
    a.launches = {k: a.launches.get(k, 0) + b.launches.get(k, 0)
                  for k in {**a.launches, **b.launches}}
    return a


# The hot-key tier and the ingress step across ranks (31a's second part;
# tests/torch_mp_seqs.py runs the same two sequences at 2 ranks x 2 nodes
# against the JAX package's one process of 4).  Written over a namespace
# ``m`` of one package's modules (:func:`port_seq_mods`): ``Tree``,
# ``batched``, ``bits``, ``DP`` (device_prep), ``serve``, ``TreeConfig``
# and ``receipts(step, carry)``.
MR_SEQ_B = 1024                 # the cache sequence's rows a node
MR_SEQ_CFG = dict(pages_per_node=2048, locks_per_node=512,
                  step_capacity=1024, host_step_capacity=16, chunk_pages=32)
# the ingress sequence's: a smaller exchange keeps its storm's rounds
# cheap for the plain path of eight nodes on the CPU
MR_INGRESS_B = 128
MR_INGRESS_CFG = dict(MR_SEQ_CFG, step_capacity=256)
MR_SEQ_SLOTS = 4096             # the cache's slots
MR_SEQ_HOT = 512                # keys filled, hottest ranks first
MR_SEQ_RESID = 512              # the cached staged step's residual rows
MR_SEQ_W = 512                  # the ingress step's width (one rung)


def port_seq_mods(device: str):
    """The port's module handles for :func:`mr_cache_seq` and
    :func:`mr_ingress_seq` on ``device``."""
    import types

    from sherman_tpu_torch import serve
    from sherman_tpu_torch.config import TreeConfig
    from sherman_tpu_torch.models import batched
    from sherman_tpu_torch.models.btree import Tree
    from sherman_tpu_torch.ops import bits
    from sherman_tpu_torch.workload import device_prep as DP
    return types.SimpleNamespace(
        Tree=Tree, batched=batched, bits=bits, DP=DP, serve=serve,
        TreeConfig=TreeConfig,
        receipts=lambda step, carry: list(step.receipts(carry)))


def _seq_tree(m, cluster, rows: int = MR_SEQ_B):
    """20,000 keys ``mix64(rank ^ MR_SALT)`` at fill 0.8, values ``key ^
    0xDEADBEEF`` (the staged receipts' check), one engine of ``rows`` a
    node with its router."""
    tree = m.Tree(cluster)
    keys = m.bits.mix64_np(np.arange(MR_A_KEYS, dtype=np.uint64)
                           ^ np.uint64(MR_SALT))
    order = np.argsort(keys)
    m.batched.bulk_load(tree, keys[order], (keys ^ VAL_XOR)[order],
                        fill=0.8)
    eng = m.batched.BatchedEngine(tree, batch_per_node=rows)
    eng.attach_router()
    return tree, eng, keys


def _answers_ok(what: str, got, keys, want) -> None:
    vals, found = got
    if not (np.asarray(found).all()
            and np.array_equal(np.asarray(vals), want)):
        raise AssertionError(f"{what}: {int((~np.asarray(found)).sum())} "
                             f"of {keys.size} keys missing or wrong")


def _cache_rec(cache) -> dict:
    st = cache.stats()
    return {"stats": np.asarray([st[k] for k in (
                "hits", "misses", "invalidations", "evictions", "fills",
                "placement_failures", "cached_keys")]),
            "mirror": np.stack(cache._table_host()),
            "tables": np.stack([_np(t) for t in cache.device_tables()])}


def mr_cache_seq(m, cluster, keeper=None, tmp=None) -> dict:
    """The hot-key tier: a 4,096-slot cache filled with the 512 hottest
    ranks, three cached aligned staged steps with a 512-row residual, a
    cached ``search`` and ``search_combined``, then an insert that
    rewrites 64 cached keys (the host drops them) and splits the leaves
    of 64 others (their entries go stale: the probe clears them on the
    device), and the re-search.  -> answers, receipts, cache stats, the
    mirror and the device tables after each part."""
    tree, eng, keys = _seq_tree(m, cluster)
    N = cluster.cfg.machine_nr
    vals = keys ^ VAL_XOR
    cache = eng.attach_leaf_cache(slots=MR_SEQ_SLOTS)
    fill = cache.fill(keys[:MR_SEQ_HOT])
    out = {"fill": np.asarray([fill[k] for k in ("placed", "failed",
                                                  "resolved")])}
    step, (new_carry, tb, rt, rk) = m.DP.make_staged_step(
        eng, n_keys=MR_A_KEYS, theta=0.99, salt=MR_SALT, batch=MR_SEQ_B,
        dev_b=MR_SEQ_B, log2_bins=16, fusion="aligned", leaf_cache=cache,
        dev_b_resid=MR_SEQ_RESID)
    dsm = eng.dsm
    carry, counters = new_carry(), dsm.counters
    for _ in range(3):
        counters, carry = step(dsm.pool, counters, tb, rt, rk, carry)
    dsm.counters = counters
    out["ro"] = np.asarray(m.receipts(step, carry))
    if list(out["ro"][:3]) != [3, 1, 3 * MR_SEQ_B * N]:
        raise AssertionError(f"cached staged receipts {out['ro']}")
    q = keys[:3000]
    got = eng.search(q)
    _answers_ok("cached search", got, q, vals[:3000])
    out["search"] = np.asarray(got[0])
    dup = np.concatenate([keys[:256], keys[4000:4256]] * 4)
    got = eng.search_combined(dup)
    _answers_ok("cached search_combined", got, dup, dup ^ VAL_XOR)
    out["combined"] = np.asarray(got[0])
    for k, v in _cache_rec(cache).items():
        out[f"read_{k}"] = v
    # 64 cached keys rewritten, and 8 fresh keys just past each of 64
    # other cached keys (their leaves split under them)
    fresh = (keys[128:192, None]
             + np.arange(1, 9, dtype=np.uint64)).reshape(-1)
    if np.isin(fresh, keys).any():
        raise AssertionError("cache sequence: a fresh key exists")
    wk = np.concatenate([keys[64:128], fresh])
    wv = np.concatenate([keys[64:128] ^ np.uint64(0x5A5A), fresh ^ VAL_XOR])
    st = eng.insert(wk, wv)
    out["insert"] = np.asarray([st[k] for k in ("applied", "host_path",
                                                "device_splits")])
    if not st["device_splits"]:
        raise AssertionError(f"cache sequence: no split: {st}")
    want = vals.copy()
    want[64:128] = keys[64:128] ^ np.uint64(0x5A5A)
    got = eng.search(keys[:MR_SEQ_HOT])
    _answers_ok("re-search", got, keys[:MR_SEQ_HOT], want[:MR_SEQ_HOT])
    out["research"] = np.asarray(got[0])
    got = eng.search(fresh)
    _answers_ok("fresh keys", got, fresh, fresh ^ VAL_XOR)
    for k, v in _cache_rec(cache).items():
        out[f"write_{k}"] = v
    if not out["write_stats"][2] > out["read_stats"][2] + 64:
        raise AssertionError("cache sequence: no stale entry cleared on "
                             f"the device: {out['write_stats']}")
    return out


def mr_ingress_seq(m, cluster, keeper=None, tmp=None) -> dict:
    """The ingress step and the front door: a 512-wide step with the
    prep on the host and on the device, the same with the cache (a device
    prep falls back to the host), a batch whose router seeds are stale
    after a storm of 500 inserts into one leaf's range (a second engine
    whose descent budget they overrun: the straggler rescue runs, with
    each prep), then ``ShermanServer`` over a one-rung ladder: ``start``
    with its calibration, three reads submitted one at a time, ``stop``.
    -> answers, rescue counts, cache stats and tables, served ops."""
    tree, eng, keys = _seq_tree(m, cluster, MR_INGRESS_B)
    rng = np.random.default_rng(9)
    q = keys[rng.integers(0, keys.size, 400)]
    out = {}
    for impl in ("host", "device"):
        step = m.DP.make_ingress_step(eng, width=MR_SEQ_W, prep_impl=impl)
        got = step(q)
        _answers_ok(f"ingress ({impl})", got, q, q ^ VAL_XOR)
        out[impl] = np.asarray(got[0])
    cache = eng.attach_leaf_cache(slots=MR_SEQ_SLOTS)
    cache.fill(keys[:MR_SEQ_HOT])
    qh = np.concatenate([keys[:200], q[:200]])
    for impl in ("host", "device"):
        step = m.DP.make_ingress_step(eng, width=MR_SEQ_W, leaf_cache=cache,
                                      prep_impl=impl)
        if step.prep_impl != "host":
            raise AssertionError("a cached ingress step kept device prep")
        got = step(qh)
        _answers_ok(f"cached ingress ({impl})", got, qh, qh ^ VAL_XOR)
        out[f"cached_{impl}"] = np.asarray(got[0])
    for k, v in _cache_rec(cache).items():
        out[f"cache_{k}"] = v
    # stale seeds: eng_s's router predates the storm, and its descent
    # budget (4 levels, no chase slack: 16 rounds) is shorter than the
    # chase from the old leaf across the 20 leaves it split into
    eng_s = m.batched.BatchedEngine(
        tree, batch_per_node=MR_INGRESS_B,
        tcfg=m.TreeConfig(max_level=4, sibling_chase_budget=0))
    eng_s.attach_router()
    sk = np.sort(keys)
    lo, hi = sk[5000], sk[5001]
    fresh = lo + np.arange(1, 501, dtype=np.uint64) * ((hi - lo)
                                                       // np.uint64(502))
    st = eng.insert(fresh, fresh ^ VAL_XOR)
    out["storm"] = np.asarray([st[k] for k in ("applied", "host_path",
                                               "device_splits")])
    qs = np.concatenate([fresh[::5], sk[4990:5010]])
    rescues = []
    search = eng_s.search

    def counted(k, *a, **kw):
        rescues.append(len(k))
        return search(k, *a, **kw)

    eng_s.search = counted
    for impl in ("host", "device"):
        step = m.DP.make_ingress_step(eng_s, width=MR_SEQ_W, prep_impl=impl)
        n0 = len(rescues)
        got = step(qs)
        _answers_ok(f"stale seeds ({impl})", got, qs, qs ^ VAL_XOR)
        if len(rescues) == n0:
            raise AssertionError(f"stale seeds ({impl}): no rescue ran")
        out[f"stale_{impl}"] = np.asarray(got[0])
    out["rescues"] = np.asarray(rescues)
    # the front door over one rung, every rank driving the same requests
    srv = m.serve.ShermanServer(eng, m.serve.ServeConfig(
        widths=(MR_SEQ_W,)))
    try:
        srv.start(calib_keys=keys)
        for i in range(3):
            rq = keys[rng.integers(0, keys.size, 50)]
            got = srv.submit("read", rq).result(timeout=300)
            _answers_ok(f"front door read {i}", got, rq, rq ^ VAL_XOR)
            out[f"door_{i}"] = np.asarray(got[0])
    finally:
        srv.stop()
    out["door_ops"] = np.asarray([srv.admitted_ops, srv.served_ops])
    for k, v in _cache_rec(cache).items():
        out[f"door_cache_{k}"] = v
    return out


#: 31a's second part: (name, sequence, its cluster's per-node sizes)
MR_SEQS = (("cache", mr_cache_seq, MR_SEQ_CFG),
           ("ingress", mr_ingress_seq, MR_INGRESS_CFG))


def _mr_ycsb_a(eng, q, wv, is_read, cur, ranks) -> None:
    """One YCSB-A step's checks (phase 6's): one applied write a written
    key, every read the pre-step value or the step's own write."""
    from sherman_tpu_torch.models import batched
    out, found, st = eng.mixed(q, wv, is_read)
    w = ~is_read
    if not np.isin(st[w], (batched.ST_APPLIED, batched.ST_SUPERSEDED)).all():
        raise AssertionError(f"31b YCSB-A: write statuses {np.bincount(st[w])}")
    if int((st[w] == batched.ST_APPLIED).sum()) != np.unique(q[w]).size:
        raise AssertionError("31b YCSB-A: not one applied write a key")
    written = np.zeros(q.size, bool)
    written[is_read] = np.isin(ranks[is_read], ranks[w])
    ok = found[is_read] & ((out[is_read] == cur[ranks[is_read]])
                           | (written[is_read] & (out[is_read]
                                                  == wv[is_read])))
    if not ok.all():
        raise AssertionError(f"31b YCSB-A: {int((~ok).sum())} reads wrong")
    cur[ranks[w]] = wv[w]


def _mr_cache_b(eng_c, staged: tuple, ro_at: list, cur, n_keys: int,
                salt: int, c_steps: int) -> dict:
    """31b's hot-key tier and ingress step on the 100 M-key tree: a
    65,536-slot cache filled with the hottest ranks; the staged YCSB-C
    ``aligned`` step with the cache (its residual cap from two warm-up
    steps, as phase 23b sizes it) for ``c_steps`` steps after a warm-up
    one, its receipts equal to the uncached step's after as many steps
    (``ro_at``), the hit ratio beside ``expected_hit_ratio``; then the
    ingress step at the ladder's top rung (65,536) with the prep on the
    host, on the device and with the cache, every answer checked."""
    from sherman_tpu_torch.workload import device_prep as DP
    from sherman_tpu_torch.workload.zipf import ZipfGen, expected_hit_ratio
    rec: dict = {"slots": MR_CACHE_SLOTS, "c_steps": c_steps}
    pool, counters = eng_c.dsm.pool, eng_c.dsm.counters
    per = MR_BATCH_C // 8
    t = time.perf_counter()
    cache = eng_c.attach_leaf_cache(slots=MR_CACHE_SLOTS)
    fill = cache.fill(keys_of(np.arange(cache.capacity, dtype=np.uint64),
                              salt))
    rec["fill"] = {**fill, "s": time.perf_counter() - t}
    mk = lambda **kw: DP.make_staged_step(
        eng_c, n_keys=n_keys, theta=0.99, salt=salt, batch=per, dev_b=per,
        fusion="aligned", staged=staged, leaf_cache=cache, **kw)
    probe, (new_p, *_) = mk()
    cp = new_p()
    for _ in range(2):
        cp = probe(pool, counters, *staged, cp)[1]
    cp = probe.receipts(cp)
    # per node: the fullest node's unique rows less a node's mean unique
    # hits (2 steps of 8 nodes), 5% over, in blocks of 8,192
    resid = max(1, cp[4] - cp[6] // 16)
    cap_r = min(per, -(-int(resid * 1.05) // 8192) * 8192)
    on, (new_on, *_) = mk(dev_b_resid=cap_r)
    carry, walls = new_on(), []
    for _ in range(c_steps + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        carry = on(pool, counters, *staged, carry)[1]
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    got = on.receipts(on.drain(carry))
    if got[:5] != ro_at[c_steps][:5]:
        raise AssertionError(f"31b cached receipts {got} != the uncached "
                             f"step's {ro_at[c_steps]}")
    ops = (c_steps + 1) * MR_BATCH_C
    rec.update(dev_b_resid=cap_r, receipts=got, ms_on=walls[1:],
               hit_ratio=got[5] / ops,
               expected_hit_ratio=expected_hit_ratio(n_keys, 0.99,
                                                     fill["placed"]),
               uniq_hits_a_step=got[6] / (c_steps + 1))
    # the ingress step at the top rung, every rank driving the same keys
    zg = ZipfGen(n_keys, 0.99, seed=29)
    rec["ingress_ms"] = {}
    for impl, lc in (("host", None), ("device", None), ("cached", cache)):
        st = DP.make_ingress_step(eng_c, width=MR_INGRESS_W, leaf_cache=lc,
                                  prep_impl="host" if lc else impl)
        ms = []
        for _ in range(MR_INGRESS_BATCHES):
            ranks = zg.sample(MR_INGRESS_W)
            q = keys_of(ranks, salt)
            t = time.perf_counter()
            vals, found = st(q)
            ms.append((time.perf_counter() - t) * 1e3)
            if not (found.all() and np.array_equal(vals, cur[ranks])):
                raise AssertionError(f"31b ingress ({impl}): "
                                     f"{int((~found).sum())} keys missing "
                                     "or wrong")
        rec["ingress_ms"][impl] = ms
    rec["stats"] = {k: v for k, v in cache.stats().items()
                    if k in ("hits", "misses", "invalidations",
                             "cached_keys", "hit_ratio")}
    eng_c.detach_leaf_cache()
    return rec


def _mr_rank_b(keeper, rank: int, d: str, arg: dict, log_c) -> dict:
    """31b in a rank: the north-star keyspace over 2 ranks x 4 nodes (its
    hot-key tier and ingress step join ``log_c``, window ``2c``)."""
    from sherman_tpu_torch.bench import build
    from sherman_tpu_torch.models import validate
    from sherman_tpu_torch.models.btree import Tree
    from sherman_tpu_torch.models import batched
    from sherman_tpu_torch.parallel import transport as T
    from sherman_tpu_torch.utils import checkpoint as CK
    from sherman_tpu_torch.workload import device_prep as DP
    from sherman_tpu_torch.workload.zipf import ZipfGen
    n_keys, steps, ck_keys = arg["keys"], arg["steps"], arg["ck_keys"]
    rec = {}

    def say(what: str, key: str) -> None:
        if rank == 0:
            print(f"[r0] 31b {what}: {json.dumps(rec[key])}", flush=True)

    torch.cuda.reset_peak_memory_stats()
    with ShapeLog() as log:
        t = time.perf_counter()
        b = build(n_keys, MR_BATCH_C, MR_BATCH_A, "cuda", machine_nr=8,
                  step_capacity=MR_CAP, keeper=keeper,
                  log=lambda m: print(f"[r{rank}] {m}", flush=True))
        rec["build_s"] = time.perf_counter() - t
        eng_c, eng_a, salt = b["eng_c"], b["eng_a"], b["salt"]
        cur = b["vals"].copy()
        # staged aligned YCSB-C: every op verified on the card
        per = MR_BATCH_C // 8
        step, (new_carry, tb, rt, rk) = DP.make_staged_step(
            eng_c, n_keys=n_keys, theta=0.99, salt=salt, batch=per,
            dev_b=per, fusion="aligned")
        pool, counters = eng_c.dsm.pool, eng_c.dsm.counters
        carry = new_carry()
        walls, ro_at = [], []
        for s in range(steps + 1):          # step 0: the warm-up
            if s == steps:
                T.reset_split()
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, carry = step(pool, counters, tb, rt, rk, carry)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
            if s == steps:
                rec["split_c"] = T.split()
            ro_at.append(step.receipts(step.drain(carry)))
        ro = ro_at[-1]
        if ro[:3] != [steps + 1, 1, (steps + 1) * MR_BATCH_C]:
            raise AssertionError(f"31b YCSB-C receipts {ro}")
        rec["ycsb_c_ms"] = walls[1:]
        rec["ycsb_c_receipts"] = ro
        say("staged YCSB-C ms a step", "ycsb_c_ms")
        say("staged YCSB-C exchange split (last step)", "split_c")
    # the hot-key tier and the ingress step on this tree (window 2c), before
    # YCSB-A rewrites values: the staged receipts check key ^ 0xDEADBEEF
    with ShapeLog() as log_b:
        rec["cache"] = _mr_cache_b(eng_c, (tb, rt, rk), ro_at, cur, n_keys,
                                   salt, arg["c_steps"])
        rec["cache"]["ms_off"] = rec["ycsb_c_ms"]
        say("cache and ingress", "cache")
    log_c = _join_logs(log_c, log_b)
    with ShapeLog() as log_a:
        # YCSB-A 50/50 through the fused mixed step, every read checked
        # (the window 2r again)
        zipf = ZipfGen(n_keys, 0.99, seed=7)
        rng = np.random.default_rng(5)
        walls = []
        for s in range(steps + 1):
            ranks = zipf.sample(MR_BATCH_A)
            q = keys_of(ranks, salt)
            is_read = rng.random(MR_BATCH_A) < 0.5
            wv = q ^ np.uint64((0x9E3779B97F4A7C15 * (s + 1)) & (2**64 - 1))
            if s == steps:
                T.reset_split()
            t = time.perf_counter()
            _mr_ycsb_a(eng_a, q, wv, is_read, cur, ranks)
            walls.append((time.perf_counter() - t) * 1e3)
        rec["split_a"] = T.split()
        rec["ycsb_a_ms"] = walls[1:]
        say("YCSB-A ms a step", "ycsb_a_ms")
        # a storm chunk of fresh inserts with device splits: 20 keys just
        # past the low fence of each of 4,096 neighbouring leaves (a leaf
        # at fill 0.75 has 12 free slots, so every one splits)
        lows = b["tree"]._bulk_leaf_dir[1]
        fresh = (lows[1000:1000 + MR_STORM_LEAVES, None]
                 + np.arange(1, 21, dtype=np.uint64)).reshape(-1)
        t = time.perf_counter()
        st = eng_a.insert(fresh, fresh ^ VAL_XOR)
        rec["storm_s"] = time.perf_counter() - t
        rec["storm"] = {k: st[k] for k in ("applied", "host_path", "rounds")}
        rec["storm"]["device_splits"] = st.get("device_splits", 0)
        if not rec["storm"]["device_splits"]:
            raise AssertionError(f"31b storm: no device splits: {st}")
        _mr_verify(eng_a, fresh)
        say("storm", "storm")
        t = time.perf_counter()
        info = validate.check_structure_device(b["tree"])
        rec["validate_ms"] = (time.perf_counter() - t) * 1e3
        if info["keys"] != n_keys + fresh.size:
            raise AssertionError(f"31b validator: {info}")
    log = _join_logs(log, log_a)
    rec["launches"] = log.launches
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    # the collective checkpoint and its restore into a fresh cluster
    if ck_keys != n_keys:
        del b, eng_c, eng_a, step, pool, counters
        gc.collect()
        torch.cuda.empty_cache()
        b = build(ck_keys, MR_BATCH_C, MR_BATCH_A, "cuda", machine_nr=8,
                  step_capacity=MR_CAP, keeper=keeper,
                  log=lambda m: print(f"[r{rank}] {m}", flush=True))
        cur = b["vals"]
    ck = os.path.join(d, "mr_b.npz")
    t = time.perf_counter()
    CK.checkpoint(b["cluster"], ck)
    rec["ck_s"] = time.perf_counter() - t
    rec["ck_bytes"] = sum(os.path.getsize(f) for f in
                          glob.glob(os.path.join(d, "mr_b.npz*")))
    del b
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    c2 = CK.restore(ck, device="cuda", keeper=keeper)
    rec["restore_s"] = time.perf_counter() - t
    say("checkpoint s", "ck_s")
    say("restore s", "restore_s")
    e2 = batched.BatchedEngine(Tree(c2), batch_per_node=MR_BATCH_A // 8)
    e2.attach_router()
    ranks = np.random.default_rng(11).integers(0, ck_keys, MR_SAMPLE,
                                               dtype=np.uint64)
    got, found = e2.search(keys_of(ranks, salt))
    if not (found.all() and np.array_equal(got, cur[ranks])):
        raise AssertionError("31b: the restored tree lost sampled keys")
    log.check(f"31b rank {rank}", ("gather_pages", "writeback", "exchange"))
    log_c.check(f"31a-b rank {rank} (cache, ingress)",
                ("gather_pages", "writeback", "exchange"))
    rec["launches_c"] = log_c.launches
    # the ranks replay in turn: neither times its kernels while the
    # other's run on the shared card
    for r in range(2):
        keeper.barrier(f"replay-{r}")
        if r == rank:
            rec["shapes"] = replay(log, "2r")
            rec["shapes_c"] = replay(log_c, "2c")
    keeper.barrier("replayed")
    return rec


def _mr_rank_stall_preempt(keeper, rank: int, d: str) -> dict:
    """31c's stall (rank 1 stopped by the parent: rank 0's guarded
    barrier names it inside its deadline, both resume on the retry) and
    preemption (SIGTERM on rank 0: both checkpoint at one step)."""
    from sherman_tpu_torch.utils import checkpoint as CK
    from sherman_tpu_torch.utils import failure
    cluster, eng, keys = _mr_small(keeper)
    rec = {}
    keeper.barrier("stall-sync", timeout_s=120)
    print("MR-READY", flush=True)
    if rank == 1:
        time.sleep(3)        # the parent stops this rank in here
        keeper.barrier("stalled", timeout_s=120)
    else:
        t0 = time.monotonic()
        try:
            keeper.barrier("stalled", timeout_s=4)
            raise AssertionError("31c: the stalled peer's barrier passed")
        except failure.PeerFailure as e:
            rec["stall_detect_s"] = time.monotonic() - t0
            rec["missing"] = e.missing
            if e.missing != [1] or rec["stall_detect_s"] > 8:
                raise AssertionError(f"31c stall: {e.missing} "
                                     f"{rec['stall_detect_s']:.1f} s")
        print("MR-DETECT", flush=True)
        keeper.barrier("stalled", timeout_s=120)     # the retry
    _mr_verify(eng, keys)
    guard = failure.PreemptionGuard(keeper)
    keeper.barrier("loop")
    print("MR-LOOP", flush=True)
    sync_at = -1
    for step in range(3000):
        _mr_verify(eng, keys[:32])
        if guard.should_act(step):
            sync_at = step
            break
        time.sleep(0.01)
    guard.close()
    if sync_at < 0:
        raise AssertionError("31c: the preemption notice never spread")
    CK.checkpoint(cluster, os.path.join(d, "mr_preempt.npz"))
    rec["preempt_step"] = sync_at
    return rec


def _mr_rank_death(keeper, rank: int, d: str) -> dict:
    """31c's death drill: both ranks checkpoint, then rank 1 is killed by
    the parent and rank 0 waits in a long guarded barrier, which the
    heartbeat monitor ends."""
    from sherman_tpu_torch.utils import checkpoint as CK
    cluster, eng, keys = _mr_small(keeper)
    CK.checkpoint(cluster, os.path.join(d, "mr_death.npz"))
    keeper.barrier("armed")
    print("MR-ARMED", flush=True)
    if rank == 1:
        time.sleep(600)
    keeper.barrier("after-crash", timeout_s=600)
    raise AssertionError("31c: the barrier after the kill passed")


def _mr_rank_recover(keeper, rank: int, d: str) -> dict:
    """A relaunched pair restores the death drill's checkpoint."""
    from sherman_tpu_torch.models import batched
    from sherman_tpu_torch.models.btree import Tree
    from sherman_tpu_torch.utils import checkpoint as CK
    c2 = CK.restore(os.path.join(d, "mr_death.npz"), device="cuda",
                    keeper=keeper)
    eng = batched.BatchedEngine(Tree(c2), batch_per_node=64)
    _mr_verify(eng, keys_of(np.arange(MR_FAIL_KEYS, dtype=np.uint64),
                            MR_SALT))
    return {"recovered_keys": MR_FAIL_KEYS}


def rank_main(argv: list) -> int:
    """A rank process of phase 31: ``chip_smoke.py --rank R --mode M --dir
    D [--arg JSON]`` with ``SHERMAN_COORD``/``SHERMAN_NPROC``/
    ``SHERMAN_PROC_ID`` set by the parent.  It loads the kernels the
    parent built and prints its record as one ``MR {...}`` line."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    opt = lambda k, d=None: argv[argv.index(k) + 1] if k in argv else d
    rank, mode, d = int(opt("--rank")), opt("--mode"), opt("--dir")
    arg = json.loads(opt("--arg", "{}"))
    from sherman_tpu_torch.ops import page_kernels as PK
    from sherman_tpu_torch.parallel import bootstrap
    global BASELINE
    keeper = bootstrap.init_multihost()
    PK.load_library()
    BASELINE = Baseline(os.path.join(PK.BUILD_DIR, "libbaseline_kernels.so"))
    rec = {"rank": rank, "mode": mode}
    if mode == "main":
        rec_a, log_c = _mr_rank_a(keeper, rank, d)
        rec.update(rec_a)
        gc.collect()
        torch.cuda.empty_cache()
        rec.update(_mr_rank_b(keeper, rank, d, arg, log_c))
        gc.collect()
        torch.cuda.empty_cache()
        rec.update(_mr_rank_stall_preempt(keeper, rank, d))
    elif mode == "death":
        rec.update(_mr_rank_death(keeper, rank, d))
    else:
        rec.update(_mr_rank_recover(keeper, rank, d))
    rec["peak_gib_rank"] = torch.cuda.max_memory_allocated() / 2**30
    keeper.barrier("rank-done")
    print("MR " + json.dumps(rec), flush=True)
    return 0


class Ranks:
    """Two rank processes of this script sharing the card, their output
    lines read on threads, printed and handed to ``on_line``; every child
    is killed on exit."""

    def __init__(self, mode: str, d: str, arg: dict | None = None,
                 env: dict | None = None):
        import queue
        import socket
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        self.q: queue.Queue = queue.Queue()
        self.procs = []
        for r in range(2):
            e = dict(os.environ, SHERMAN_COORD=f"localhost:{port}",
                     SHERMAN_NPROC="2", SHERMAN_PROC_ID=str(r),
                     **(env or {}))
            p = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank",
                 str(r), "--mode", mode, "--dir", d, "--arg",
                 json.dumps(arg or {})],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=e,
                text=True, cwd=ROOT)
            self.procs.append(p)
            threading.Thread(target=self._pump, args=(r, p),
                             daemon=True).start()
        self.recs: dict = {}
        self.lines: list = [[], []]

    def _pump(self, r: int, p) -> None:
        for line in p.stdout:
            self.q.put((r, line.rstrip("\n")))
        self.q.put((r, None))

    def run(self, timeout: float, on_line=None) -> list:
        """Until both ranks closed their output (or ``timeout``) ->
        their exit codes."""
        import queue
        done, t_end = 0, time.perf_counter() + timeout
        try:
            while done < 2:
                try:
                    r, line = self.q.get(timeout=max(
                        0.1, t_end - time.perf_counter()))
                except queue.Empty:
                    raise AssertionError(f"phase 31: ranks still running "
                                         f"after {timeout:.0f} s")
                if line is None:
                    done += 1
                    continue
                self.lines[r].append(line)
                if line.startswith("MR "):
                    self.recs[r] = json.loads(line[3:])
                else:
                    _log(f"[rank {r}] {line[-400:]}")
                if on_line is not None:
                    on_line(r, line)
            return [p.wait(timeout=60) for p in self.procs]
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()


def _merge_shapes(recs: list, window: str = "shapes") -> dict:
    """The two ranks' replayed shapes as one window: launches summed by
    (kernel, shape), rank 0's timings (the ranks' shapes are the same)."""
    out: dict = {}
    for k in KERNELS:
        by = {}
        for rec in recs:
            for e in rec[window].get(k, []):
                key = json.dumps(e.get("shape", [e.get("rows"),
                                                 e.get("pool_pages"),
                                                 e.get("lanes"),
                                                 e.get("ok"),
                                                 e.get("stop_level")]))
                if key in by:
                    by[key]["launches"] += e["launches"]
                else:
                    by[key] = dict(e)
        if by:
            out[k] = list(by.values())
    return out


def multirank_full_width(smi: str, t_smoke: float | None = None) -> dict:
    """Phase 31 -> {kernel: [per-shape entries of windows ``2r`` and
    ``2c``]}."""
    import signal
    cuts = budget_cuts("31", t_smoke) if t_smoke is not None else {}
    n_keys = MR_CUT_KEYS if "keys" in cuts else MR_KEYS
    ck_keys = MR_CUT_KEYS if "ck_keys" in cuts else n_keys
    steps = 2 if "steps" in cuts else MR_STEPS
    c_steps = 2 if "c_steps" in cuts else MR_CACHE_STEPS
    c_steps = min(c_steps, steps)   # the uncached receipts it is held to
    t31 = time.perf_counter()
    d = tempfile.mkdtemp(prefix="sherman_mr_")
    try:
        if shutil.disk_usage(d).free < 12 << 30:
            raise AssertionError("phase 31 needs 12 GiB free for the "
                                 "collective checkpoints")
        ranks = Ranks("main", d, {"keys": n_keys, "steps": steps,
                                  "ck_keys": ck_keys, "c_steps": c_steps},
                      {"SHERMAN_HEARTBEAT_S": str(MR_STALL_HB_S)})

        def orchestrate(r: int, line: str) -> None:
            if r == 1 and line == "MR-READY":
                os.kill(ranks.procs[1].pid, signal.SIGSTOP)
            elif r == 0 and line == "MR-DETECT":
                os.kill(ranks.procs[1].pid, signal.SIGCONT)
            elif r == 0 and line == "MR-LOOP":
                time.sleep(0.3)
                os.kill(ranks.procs[0].pid, signal.SIGTERM)

        # the one-process CPU run of 31a while the ranks work
        res, clusters = mr_parity_seq(clusters_a(None, "cpu"), None, d,
                                      "cpu")
        want = {**_mr_state(clusters),
                **{f"res_{k}": np.asarray(v) for k, v in res.items()}}
        del clusters
        # and of its second part, the hot-key tier and the ingress step
        want_seq = {}
        for name, seq, cfg in MR_SEQS:
            cl = seq_cluster(None, cfg, "cpu")
            res = seq(port_seq_mods("cpu"), cl)
            want_seq[name] = {**_mr_state([cl]), **{
                f"res_{k}": np.asarray(v) for k, v in res.items()}}
            del cl
        rcs = ranks.run(900, orchestrate)
        if rcs != [0, 0] or len(ranks.recs) != 2:
            raise AssertionError(f"phase 31 ranks exited {rcs}")
        recs = [ranks.recs[0], ranks.recs[1]]
        parts = [dict(np.load(os.path.join(d, f"mr_a_r{r}.npz")))
                 for r in range(2)]
        for k, v in want.items():
            got = parts[0][k] if k.startswith("res_") else np.concatenate(
                [p[k] for p in parts])
            if not np.array_equal(got, np.asarray(v).astype(got.dtype)):
                raise AssertionError(f"31a: {k} differs between two ranks "
                                     "on the card and one CPU process")
        _log("31a: 2 ranks x 4 nodes on the card bit-identical to one "
             "process of 8 nodes on the CPU (pools, locks, counters, "
             "answers, receipts; K4 layout shapes replayed exact: "
             f"{recs[0]['a_layout_shapes']})")
        for name, want_n in want_seq.items():
            parts = [dict(np.load(os.path.join(d, f"mr_{name}_r{r}.npz")))
                     for r in range(2)]
            if sorted(parts[0]) != sorted(want_n):
                raise AssertionError(f"31a {name}: the ranks' results "
                                     f"{sorted(parts[0])} != the CPU's")
            for k, v in want_n.items():
                got = parts[0][k] if k.startswith("res_") else \
                    np.concatenate([p[k] for p in parts])
                if k.startswith("res_") and not np.array_equal(
                        parts[1][k], got):
                    raise AssertionError(f"31a {name}: the ranks disagree "
                                         f"on {k}")
                if not np.array_equal(got, np.asarray(v).astype(got.dtype)):
                    raise AssertionError(
                        f"31a {name}: {k} differs between two ranks on "
                        "the card and one CPU process")
            _log(f"31a {name}: 2 ranks x 4 nodes on the card bit-identical "
                 "to one process of 8 nodes on the CPU (answers, receipts, "
                 "cache stats, mirrors and device tables, pools, locks, "
                 f"counters: {len(want_n)} arrays)")
        if recs[0]["preempt_step"] != recs[1]["preempt_step"]:
            raise AssertionError("31c: the ranks checkpointed at steps "
                                 f"{recs[0]['preempt_step']} and "
                                 f"{recs[1]['preempt_step']}")
        # the death drill, then a relaunched pair restores
        t = time.perf_counter()
        death = Ranks("death", d, env={"SHERMAN_HEARTBEAT_S": str(MR_HB_S)})
        killed = []

        def kill(r: int, line: str) -> None:
            if r == 1 and line == "MR-ARMED":
                killed.append(time.perf_counter())
                os.kill(death.procs[1].pid, signal.SIGKILL)

        rcs = death.run(300, kill)
        from sherman_tpu_torch.utils import failure
        diag = [x for x in death.lines[0] if "[1] stopped heartbeating" in x]
        end_s = time.perf_counter() - killed[0] if killed else None
        if rcs[0] != failure.HEARTBEAT_EXIT or not diag \
                or end_s > MR_HB_S + 30:
            raise AssertionError(f"31c death: rank 0 exit {rcs[0]}, "
                                 f"diagnostic {diag}, {end_s} s")
        rec = Ranks("recover", d)
        if rec.run(300) != [0, 0]:
            raise AssertionError("31c: the relaunched pair failed")
        c_s = time.perf_counter() - t
    finally:
        shutil.rmtree(d, ignore_errors=True)
    b0, b1 = recs[0], recs[1]
    # phase 6's one-process 8-node staged step in this run (absent when
    # phase 31 runs alone)
    base = STAGED_MS.get(("eight_nodes", "ycsb_c", "aligned"))
    out = {
        "card": smi, "keys": n_keys, "ck_keys": ck_keys, "steps": steps,
        "build_s": [b0["build_s"], b1["build_s"]],
        "ycsb_c_ms": b0["ycsb_c_ms"], "ycsb_c_ms_r1": b1["ycsb_c_ms"],
        "ycsb_a_ms": b0["ycsb_a_ms"], "ycsb_c_receipts": b0["ycsb_c_receipts"],
        "split_c": [b0["split_c"], b1["split_c"]],
        "split_a": [b0["split_a"], b1["split_a"]],
        "storm": b0["storm"], "storm_s": b0["storm_s"],
        "validate_ms": b0["validate_ms"], "ck_s": b0["ck_s"],
        "ck_bytes_r0": b0["ck_bytes"], "restore_s": b0["restore_s"],
        "peak_gib": [b0["peak_gib_rank"], b1["peak_gib_rank"]],
        "launches_2r": {k: b0["launches"][k] + b1["launches"][k]
                        for k in b0["launches"]},
        "cache": b0["cache"], "launches_2c": {
            k: b0["launches_c"][k] + b1["launches_c"][k]
            for k in b0["launches_c"]},
        "stall_detect_s": b0["stall_detect_s"], "missing": b0["missing"],
        "preempt_step": b0["preempt_step"], "death_end_s": end_s,
        "death_and_recover_s": c_s, "wall_s": time.perf_counter() - t31,
        "reduced": list(cuts.values())}
    if base is not None:
        out["ycsb_c_one_process_8_nodes_ms"] = base
    _log("multirank: " + json.dumps(out))
    for w in ("launches_2r", "launches_2c"):
        for k in ("gather_pages", "writeback", "exchange"):
            if not out[w].get(k):
                raise AssertionError(f"phase 31: {k} not launched on the "
                                     f"two-rank path ({w})")
    shapes = _merge_shapes(recs)
    for k, v in _merge_shapes(recs, "shapes_c").items():
        shapes.setdefault(k, []).extend(v)
    return shapes


# ---------------------------------------------------------------------------
# Phase 32: the port's linter over the tree this smoke runs from.
# ---------------------------------------------------------------------------

def lint_phase() -> dict:
    """Lint ``sherman_tpu_torch/`` and this script with the port's
    shermanlint and the committed baseline; print the ``lint`` line and
    raise unless the tree is clean.  -> the line's record."""
    from sherman_tpu_torch import analysis, shermanlint
    res = shermanlint.lint(baseline=analysis.load_baseline(
        shermanlint.DEFAULT_BASELINE))
    rec = {"files": res.files_checked, "findings": len(res.findings),
           "pragmas_by_rule": shermanlint.pragmas_by_rule(res),
           "lint_clean": res.clean}
    print(json.dumps({"lint": rec}), flush=True)
    if not res.clean:
        problems = ([f.render() for f in res.findings + res.pragma_errors]
                    + res.baseline_errors)
        raise AssertionError("phase 32: the tree does not lint clean:\n"
                             + "\n".join(problems))
    return rec


def phase31_only(argv: list) -> int:
    """``chip_smoke.py --phase31 [--mr-keys N]``: the builds, K4's parity
    on garbage inputs and phase 31 alone (its budget unset), for work on
    the two-rank path; not the smoke."""
    global BASELINE, MR_KEYS
    from sherman_tpu_torch.ops import page_kernels as PK
    if "--mr-keys" in argv:
        MR_KEYS = int(argv[argv.index("--mr-keys") + 1])
    nvcc = start_nvcc_builds()
    PK.load_library()
    BASELINE = finish_nvcc_builds(nvcc)
    exchange_parity(torch.device("cuda"))
    shapes = multirank_full_width(card())
    recs = [kernel_record(k, shapes[k]) for k in KERNELS if k in shapes]
    print(json.dumps({"kernels": recs}), flush=True)
    print(card(), flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs on the GPU",
              file=sys.stderr)
        return 2
    if "--phase31" in sys.argv:
        return phase31_only(sys.argv)
    # the black box: auto-dump bundles land here, and the flight ring
    # holds the whole run (phase 22 reads phases 19-21 back from it)
    bb = tempfile.mkdtemp(prefix="sherman_blackbox_")
    try:
        os.environ["SHERMAN_BLACKBOX_DIR"] = bb
        os.environ["SHERMAN_BLACKBOX_EVENTS"] = str(FLIGHT_EVENTS)
        return _main(bb)
    finally:
        shutil.rmtree(bb, ignore_errors=True)


def _main(bb: str) -> int:
    from sherman_tpu_torch.ops import page_kernels as PK
    t_smoke = time.perf_counter()

    n_keys, batch_c, batch_a, steps = 100_000_000, 1 << 22, 1 << 20, 8
    dev = torch.device("cuda")
    _log(f"torch {torch.__version__} cuda {torch.version.cuda} "
         f"device {torch.cuda.get_device_name(0)}")
    global BASELINE
    from sherman_tpu_torch import native
    from sherman_tpu_torch.errors import NativeUnavailableError
    t = time.perf_counter()
    nvcc = start_nvcc_builds()
    # the native host tier's g++ build runs beside nvcc and the extension
    gxx = threading.Thread(target=native.available)
    gxx.start()
    PK.load_library()
    BASELINE = finish_nvcc_builds(nvcc)
    gxx.join()
    if not native.available():
        raise NativeUnavailableError(
            f"the native host tier is unavailable: {native.load_error()}")
    _log(f"build (the extension, the earlier K1/K3, the ptxas report and "
         f"the native tier, in parallel): {time.perf_counter() - t:.3f} s")
    garbage_parity(dev)
    exchange_parity(dev)
    _log("parity on garbage inputs (K1-K4): exact")
    reference_check()
    _log("reference check (one node, 20,000 keys, card vs plain path on the "
         "CPU): pools, locks and counters bit-identical")
    staged_reference_check(1)

    with ShapeLog() as log:
        ctx = serve(n_keys, batch_c, batch_a, steps, "cuda")
    log.check("one-node", ("descent_round", "gather_pages", "writeback"))
    shapes = replay(log, "one_node")
    real_page_parity(ctx, batch_c)
    _log("one-node parity at every launched shape and on real pages: exact")
    zipf, salt = ctx["zipf"], ctx["salt"]
    qc = keys_of(zipf.sample(batch_c), salt)
    profile_step("ycsb_c", lambda: ctx["eng_c"].search_combined(qc))
    qa = keys_of(zipf.sample(batch_a), salt)
    ra = np.random.default_rng(5).random(batch_a) < 0.5
    profile_step("ycsb_a", lambda: ctx["eng_a"].mixed(qa, qa ^ VAL_XOR, ra))
    host_breakdown(ctx, batch_c)
    del qc, qa
    native_reference_check()
    for k, v in native_full_width(ctx, card(), t_smoke).items():
        shapes.setdefault(k, []).extend(v)
    _log("native host tier parity at every launched shape (K1): exact")
    for k, v in staged_windows(ctx, "one_node", batch_c, batch_a, steps,
                               ("descent_round", "gather_pages",
                                "writeback")).items():
        shapes.setdefault(k, []).extend(v)
    del ctx
    gc.collect()
    torch.cuda.empty_cache()

    reference_check(machine_nr=8, step_capacity=32, chunk_pages=64)
    _log("reference check (8 nodes, 20,000 keys, step capacity 32, card vs "
         "plain path on the CPU): pools, locks and counters bit-identical")
    staged_reference_check(8)
    for k, v in multinode(n_keys, batch_c, batch_a, steps).items():
        shapes.setdefault(k, []).extend(v)
    gc.collect()
    torch.cuda.empty_cache()

    storm_reference_check(1)
    storm_reference_check(8, n=10_000)      # 20,000 -> 10,000: time limit
    passes: list = []           # the integrity passes' records (18, 19)
    ctx = storm_build(10_000_000, 3_000_000, "cuda")
    for k, v in storm(ctx, "one_node_storm", 1 << 20,
                      ("descent_round", "gather_pages", "writeback"),
                      []).items():
        shapes.setdefault(k, []).extend(v)
    timed_validate(ctx["tree"], "18 one_node_storm validate", 13_000_000,
                   passes)
    del ctx
    gc.collect()
    torch.cuda.empty_cache()
    ctx = storm_build(2_000_000, 600_000, "cuda", machine_nr=8)
    for k, v in storm(ctx, "eight_nodes_storm", 1 << 20,
                      ("gather_pages", "writeback", "exchange"),
                      ["keys_warm 10,000,000 -> 2,000,000 and keys_fresh "
                       "3,000,000 -> 600,000 (the same 30% growth at fill "
                       "0.9), for the smoke's time limit",
                       "1,048,576 rows a call as 8 nodes of 131,072 "
                       "(step_capacity 131,072), not 1,048,576 a node"]
                      ).items():
        shapes.setdefault(k, []).extend(v)
    timed_validate(ctx["tree"], "18 eight_nodes_storm validate", 2_600_000,
                   passes)
    del ctx
    _log("storm parity at every launched shape (K1-K4): exact")
    gc.collect()
    torch.cuda.empty_cache()

    churn_reference_check(1)
    churn_reference_check(8)
    combine_reference_check(1)
    combine_reference_check(8)
    ctx = churn_build(10_000_000, 524_288, "cuda")
    for k, v in churn(ctx, "one_node_churn", 4,
                      ("descent_round", "gather_pages", "writeback"),
                      ["iterations 55 (or 30 minutes) -> 4, for the "
                       "smoke's time limit"]).items():
        shapes.setdefault(k, []).extend(v)
    timed_validate(ctx["tree"], "18 one_node_churn validate",
                   ctx["hi"] - ctx["lo"], passes)
    del ctx
    _log("churn parity at every launched shape (K1-K3): exact")
    gc.collect()
    torch.cuda.empty_cache()

    ycsb_reference_check(1)
    ycsb_reference_check(8, step_capacity=32)
    cut = budget_cuts("16", t_smoke)
    by_shape, ycsb = ycsb_matrix(10_000_000 if cut else 100_000_000, 1,
                                 "one_node_ycsb",
                                 ("descent_round", "gather_pages",
                                  "writeback"), list(cut.values()))
    for k, v in by_shape.items():
        shapes.setdefault(k, []).extend(v)
    gc.collect()
    torch.cuda.empty_cache()
    by_shape, _ = ycsb_matrix(10_000_000, 8, "eight_nodes_ycsb",
                              ("gather_pages", "writeback", "exchange"),
                              ["keys 100,000,000 -> 10,000,000, for the "
                               "smoke's time limit"])
    for k, v in by_shape.items():
        shapes.setdefault(k, []).extend(v)
    _log("YCSB parity at every launched shape (K1-K4, the scan prefetch "
         "on K2): exact")
    gc.collect()
    torch.cuda.empty_cache()

    smi = card()
    integrity_reference_check(1)
    integrity_reference_check(8, step_capacity=32)
    for k, v in integrity_full_width(ycsb, passes, smi).items():
        shapes.setdefault(k, []).extend(v)
    _log("integrity path parity at every launched shape (K1-K3): exact")

    durability_reference_check(1)
    durability_reference_check(8, step_capacity=32)
    for k, v in durability_full_width(ycsb, smi).items():
        shapes.setdefault(k, []).extend(v)
    _log("durability path parity at every launched shape (K1-K3): exact")

    t = time.perf_counter()
    flight = flight_record(bb)          # before 22a resets the plane
    obs_reference_check(1)
    obs_reference_check(8, step_capacity=32)
    _log(f"phase 22a with the flight record: {time.perf_counter() - t:.1f} s")
    for k, v in obs_full_width(ycsb, flight, smi).items():
        shapes.setdefault(k, []).extend(v)
    _log("obs path parity at every launched shape (K1-K3): exact")

    t = time.perf_counter()
    cache_reference_check(1)
    cache_reference_check(8)
    _log(f"phase 23a: {time.perf_counter() - t:.1f} s")
    for k, v in cache_full_width(ycsb, smi).items():
        shapes.setdefault(k, []).extend(v)
    del ycsb
    gc.collect()
    torch.cuda.empty_cache()
    _log("cache path parity at every launched shape (K1, K2): exact")
    t = time.perf_counter()
    heap_reference_check(1)
    heap_reference_check(8)
    _log(f"phase 24a: {time.perf_counter() - t:.1f} s")
    for k, v in heap_full_width(smi, t_smoke=t_smoke).items():
        shapes.setdefault(k, []).extend(v)
    _log("heap path parity at every launched shape (K1-K3): exact")
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    front_reference_check(1)
    front_reference_check(8)
    _log(f"phase 25a: {time.perf_counter() - t:.1f} s")
    for k, v in front_full_width(smi, t_smoke).items():
        shapes.setdefault(k, []).extend(v)
    _log("front-door path parity at every launched shape (K1-K3): exact")
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    repl_reference_check(1)
    repl_reference_check(8)
    repl_eight_node_drill()
    _log(f"phase 26a: {time.perf_counter() - t:.1f} s")
    for k, v in repl_full_width(smi, t_smoke).items():
        shapes.setdefault(k, []).extend(v)
    _log("replication path parity at every launched shape (K1-K3): exact")
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    resize_reference_check()
    _log(f"phase 27a: {time.perf_counter() - t:.1f} s")
    for k, v in resize_full_width(smi, t_smoke).items():
        shapes.setdefault(k, []).extend(v)
    _log("resize path parity at every launched shape (K1-K4): exact")
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    host_reference_check()
    _log(f"phase 28a: {time.perf_counter() - t:.1f} s")
    for k, v in host_full_width(smi, t_smoke).items():
        shapes.setdefault(k, []).extend(v)
    _log("multihost and hostfail path parity at every launched shape "
         "(K1-K3): exact")
    t = time.perf_counter()
    for k, v in tools_full_width(smi, t_smoke).items():
        shapes.setdefault(k, []).extend(v)
    _log(f"phase 30 (the drivers, replayed at every launched shape, K1-K4: "
         f"exact): {time.perf_counter() - t:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    for k, v in multirank_full_width(smi, t_smoke).items():
        shapes.setdefault(k, []).extend(v)
    _log(f"phase 31 (two ranks on the card, the hot-key tier and the "
         f"ingress step among them, replayed at every launched shape, "
         f"K2-K4: exact): {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    lint_phase()
    _log(f"phase 32 (the port's linter: clean): "
         f"{time.perf_counter() - t:.1f} s")
    recs = [kernel_record(k, shapes[k]) for k in KERNELS]

    print(json.dumps({"k1_ablations": [
        {k: e[k] for k in ("path", "rows", "active_rows", "launches", "ms",
                           "ms_before", "host_ms", "ablation_inactive_ms",
                           "ablation_fetch_only_ms", "bound_ms")}
        for e in shapes["descent_round"]]}), flush=True)
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    print(json.dumps({"k3_ablations": [
        {k: e[k] for k in ("path", "rows", "applied_rows", "launches", "ms",
                           "ms_before", "host_ms", "ablation_empty_mask_ms",
                           "library_ms")}
        for e in shapes["writeback"]],
        "launch_floor_ms": time_ms(lambda: one.fill_(1))}), flush=True)
    print(json.dumps({"kernels": recs}), flush=True)
    _log(f"smoke wall before the last lines: "
         f"{time.perf_counter() - t_smoke:.1f} s")
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(rank_main(sys.argv) if "--rank" in sys.argv else main())
