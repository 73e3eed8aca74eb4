"""The port's own knowledge that shermanlint's rules consult
(counterpart of ``sherman_tpu/analysis/registry.py``, written from the
port's code: every scope below names a function of
``sherman_tpu_torch/``).

Rules are generic mechanisms ("no host sync in a registered hot
function"); THIS module is where the port names its hot functions (the
CUDA kernels' launch wrappers among them), pool mutators, append paths,
obs increment paths and the calls that sync the card.  Patterns are
``fnmatch`` globs over ``(repo-relative path, dotted qualname)`` — see
:func:`sherman_tpu_torch.analysis.core.match_scope`.

Tests build their own :class:`Registry` pointing at fixture files, so
every rule is exercised without depending on the live tree's content.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# SL001's sync tables.  The reference's (JAX) table: ``.item()`` and the
# calls that materialize an array on the host ...
REFERENCE_SYNC_ATTR_CALLS = frozenset({"item"})
REFERENCE_SYNC_DOTTED = frozenset({
    "jax.device_get", "np.asarray", "numpy.asarray", "onp.asarray",
    "np.array", "numpy.array", "onp.array"})
# ... and torch's explicit syncs on top of it: each of these blocks the
# host until the card's queue reaches the value (or drains).  Implicit
# syncs (``if t.any():``, boolean-mask indexing, ``torch.nonzero``) are
# not calls the table can name: the rule's blind spot.
TORCH_SYNC_ATTR_CALLS = REFERENCE_SYNC_ATTR_CALLS | {
    "tolist", "cpu", "numpy", "synchronize"}
TORCH_SYNC_DOTTED = REFERENCE_SYNC_DOTTED | {"torch.cuda.synchronize"}


@dataclass
class Registry:
    # -- SL001: hot functions and launch wrappers: no host syncs --------------
    hot_functions: list[tuple[str, str]] = field(default_factory=list)
    #: attribute-chain roots whose reads are static Python config, not
    #: device tensors — ``int(cfg.machine_nr)`` is fine in a hot body
    static_roots: set[str] = field(default_factory=set)
    #: method names whose call syncs (``x.item()``, ``t.cpu()``)
    sync_attr_calls: set[str] = field(
        default_factory=lambda: set(TORCH_SYNC_ATTR_CALLS))
    #: dotted call targets that sync (``np.asarray``,
    #: ``torch.cuda.synchronize``)
    sync_dotted: set[str] = field(
        default_factory=lambda: set(TORCH_SYNC_DOTTED))

    # -- SL002: dirty-threading contract --------------------------------------
    #: terminal callee/reference names that mutate the pool
    pool_mutators: set[str] = field(default_factory=set)
    #: compositions deliberately outside the durability contract
    dirty_allowlist: list[tuple[str, str]] = field(default_factory=list)

    # -- SL003: typed errors --------------------------------------------------
    #: path globs where bare stdlib raises are banned (library code)
    library_paths: list[str] = field(default_factory=list)
    banned_raises: set[str] = field(default_factory=lambda: {
        "ValueError", "RuntimeError", "AssertionError"})

    # -- SL004: retrace hazards at program dispatch sites ---------------------
    #: callee-name globs whose RESULT is a ledgered program
    jit_factory_patterns: list[str] = field(default_factory=list)

    # -- SL005: fsync-before-ack ----------------------------------------------
    append_paths: list[tuple[str, str]] = field(default_factory=list)
    fsync_names: set[str] = field(default_factory=lambda: {
        "fsync", "_fsync", "fdatasync", "_commit"})
    durable_write_names: set[str] = field(default_factory=lambda: {"write"})

    # -- SL006: no allocation in obs increment paths --------------------------
    obs_hot_functions: list[tuple[str, str]] = field(default_factory=list)

    # -- SL007: documented knobs ----------------------------------------------
    knob_prefix: str = "SHERMAN_"
    readme: str = "README.md"
    #: extra documentation files a knob may appear in instead
    knob_docs: list[str] = field(default_factory=list)
    #: when set, SL007 checks against this text instead of reading the
    #: doc files — the hook fixture tests use
    knob_doc_text: str | None = None


_B = "sherman_tpu_torch/models/batched.py"
_DSM = "sherman_tpu_torch/parallel/dsm.py"
_DP = "sherman_tpu_torch/workload/device_prep.py"
_LC = "sherman_tpu_torch/models/leaf_cache.py"
_VH = "sherman_tpu_torch/models/value_heap.py"
_PK = "sherman_tpu_torch/ops/page_kernels.py"
_TK = "sherman_tpu_torch/parallel/transport_kernel.py"
_SRV = "sherman_tpu_torch/serve.py"
_REP = "sherman_tpu_torch/replica.py"

DEFAULT_REGISTRY = Registry(
    hot_functions=[
        # the device-step functions: each runs once per engine step, and a
        # host sync here serializes every step on the card's queue
        (_B, "descend_spmd"),
        (_B, "search_routed_spmd"),
        (_B, "search_spmd"),
        (_B, "leaf_apply_spmd"),
        (_B, "leaf_delete_apply_spmd"),
        (_B, "_resolve_leaves"),
        (_B, "_route_and_apply"),
        # the port's own split-outs of those bodies: the multi-node
        # descent, the cache-seeded resolve under search_routed_spmd (one
        # and N nodes) and the owner-routed apply
        (_B, "_descend_nodes"),
        (_B, "_routed_resolve"),
        (_B, "_routed_resolve_nodes"),
        (_B, "_route_and_apply_nodes"),
        (_B, "insert_step_spmd"),
        (_B, "delete_step_spmd"),
        (_B, "mixed_step_spmd"),
        (_DSM, "dsm_step_spmd"),
        (_DSM, "read_pages_spmd"),
        # the word-op apply is planned on the host from the step-start
        # words: _word_plan is the reference's _word_apply and must read
        # no device data (its inputs are numpy)
        (_DSM, "_word_plan"),
        (_DSM, "_apply"),
        # the staged serving loops' per-step dispatch closures: one stray
        # sync here is a per-step device round-trip.  The reference's
        # prep_core is the port's prep itself (one ledgered program), and
        # its fused form is refused by design (config.staged_fusion raises
        # ConfigError for "chained" and "fused", XLA program-structure
        # forms), so neither has a scope of its own.
        (_DP, "make_staged_step.step"),
        (_DP, "make_staged_step.prep"),
        (_DP, "make_staged_step.serve"),
        (_DP, "make_staged_step.served"),
        (_DP, "make_staged_step.verify"),
        (_DP, "make_staged_step.verify_core"),
        # mixed factory: per-step dispatch closures and device cores only
        # (phase_profile / new_carry are diagnostics that touch the host)
        (_DP, "make_staged_mixed_step.step"),
        (_DP, "make_staged_mixed_step.prep"),
        (_DP, "make_staged_mixed_step.serve*"),
        (_DP, "make_staged_mixed_step.verify*"),
        (_DP, "_two_deep_slot.*"),
        # hot-key tier: the probe/validate functions and the programs the
        # cache factories build (the reference's traced `kernel`s are the
        # port's `fn` closures), and the staged cache_probe closure
        (_LC, "probe_rows"),
        (_LC, "invalidation_mask"),
        (_LC, "slot_hash"),
        (_LC, "LeafCache._get_probe.fn"),
        (_LC, "LeafCache._get_fill.fn"),
        (_DP, "make_staged_step.cache_probe"),
        # serving front door: the per-step ingress dispatch closures (the
        # completion belongs in complete(), which materializes by design)
        (_DP, "make_ingress_step.dispatch"),
        # device-resident request plane: the on-device prep program family
        # and the device-mode ingress dispatch
        (_DP, "make_device_prep.prep_core"),
        (_DP, "make_device_prep.*"),
        (_DP, "make_ingress_step.dispatch_device"),
        (_SRV, "ShermanServer._dispatch_reads"),
        # client-contract plane: the dispatch-path queue pops run per
        # formed step under the admission lock
        (_SRV, "ShermanServer._take"),
        (_SRV, "ShermanServer._shed_expired"),
        # value heap: the handle resolve and the programs its factories
        # build (the fused read fan-out's gather phase)
        (_VH, "resolve_rows"),
        (_VH, "ValueHeap._get_resolve.fn"),
        (_VH, "ValueHeap._get_fused.fn"),
        # replication plane: the follower apply loop and the tailer poll
        # run per shipping round
        (_REP, "Follower.pump"),
        (_REP, "JournalTailer.poll"),
        # the CUDA kernels' launch wrappers (K1-K4), the port's counterpart
        # of a Pallas call inside a traced program: on a CUDA tensor each
        # checks, launches and returns without waiting for the card
        (_PK, "descent_round"),
        (_PK, "gather_pages"),
        (_PK, "read_pages_local"),
        (_PK, "writeback"),
        (_PK, "_call"),
        (_TK, "block_transpose"),
        (_TK, "all_to_all"),
        (_TK, "_launch"),
    ],
    static_roots={"cfg", "config", "self", "C", "D", "CFG", "bits",
                  "layout"},
    # the BOTTOM layer: these scatter into the pool directly (the K3
    # wrapper and its plain twin) or take dirty positionally.  Everything
    # composing them is checked for the kw-only dirty= contract.
    pool_mutators={
        "_route_and_apply", "_route_and_apply_nodes", "leaf_apply_spmd",
        "leaf_delete_apply_spmd", "writeback", "writeback_ref",
    },
    dirty_allowlist=[
        # device_prep/profiler compositions leave dirty=None — bench-only,
        # outside the durability contract
        (_DP, "*"),
        ("sherman_tpu_torch/chaos.py", "*"),
        ("sherman_tpu_torch/profile_insert.py", "*"),
        ("sherman_tpu_torch/profile_gather.py", "*"),
        ("sherman_tpu_torch/profile_staged2.py", "*"),
        ("sherman_tpu_torch/profile_prep.py", "*"),
        # the smoke's kernel replays: K3 re-run on copies of the pool to
        # time it and hold it against its plain twin, never on the served
        # tree — outside the durability contract
        ("chip_smoke.py", "garbage_parity"),
        ("chip_smoke.py", "replay_writeback"),
    ],
    # the library modules only: the command-line tools (bench, benchmark,
    # *_bench, *_drill, profile_*, tree_test, write_test, skiplist_test,
    # device_report, tools_common, shermanlint, knobs) are the
    # reference's tools/ and bench.py, which SL003 does not check
    library_paths=[
        "sherman_tpu_torch/__init__.py",
        "sherman_tpu_torch/audit.py",
        "sherman_tpu_torch/chaos.py",
        "sherman_tpu_torch/cluster.py",
        "sherman_tpu_torch/config.py",
        "sherman_tpu_torch/errors.py",
        "sherman_tpu_torch/hostlease.py",
        "sherman_tpu_torch/migrate.py",
        "sherman_tpu_torch/multihost.py",
        "sherman_tpu_torch/recovery.py",
        "sherman_tpu_torch/replica.py",
        "sherman_tpu_torch/serve.py",
        "sherman_tpu_torch/state.py",
        "sherman_tpu_torch/analysis/*",
        "sherman_tpu_torch/models/*",
        "sherman_tpu_torch/native/*",
        "sherman_tpu_torch/obs/*",
        "sherman_tpu_torch/ops/*",
        "sherman_tpu_torch/parallel/*",
        "sherman_tpu_torch/utils/*",
        "sherman_tpu_torch/workload/*",
    ],
    jit_factory_patterns=["_get_*", "wrap_program"],
    append_paths=[
        ("sherman_tpu_torch/utils/journal.py", "Journal.append"),
        # the client-contract ack records ride the same gate: an ack
        # cached in the dedup window must be durable before any future
        # resolves
        ("sherman_tpu_torch/utils/journal.py", "Journal.append_acks"),
        # quorum acks: the fence proxy is the SAME fsync domain — it
        # delegates every append to the wrapped segment after the lease
        # check
        (_REP, "_FencedJournal.append"),
        (_REP, "_FencedJournal.append_acks"),
    ],
    obs_hot_functions=[
        ("sherman_tpu_torch/obs/registry.py", "Counter.inc"),
        ("sherman_tpu_torch/obs/registry.py", "Gauge.set"),
        ("sherman_tpu_torch/obs/registry.py", "Gauge.add"),
        ("sherman_tpu_torch/obs/registry.py", "Histogram.record"),
        ("sherman_tpu_torch/obs/slo.py", "LatencyTracker.record"),
        ("sherman_tpu_torch/obs/slo.py", "WindowedRate.add"),
        ("sherman_tpu_torch/obs/slo.py", "SloTracker.observe"),
        # per-batch accounting paths: plain integer adds only; each
        # collector allocates at PULL time, off the hot path
        (_LC, "LeafCache._note_probe"),
        ("sherman_tpu_torch/migrate.py", "Migrator._on_dirty_clear"),
        ("sherman_tpu_torch/migrate.py", "Migrator._poll_dirt"),
        (_SRV, "ShermanServer._note_*"),
        (_VH, "ValueHeap._note_*"),
        ("sherman_tpu_torch/audit.py", "Auditor._note_cost"),
        (_B, "BatchedEngine._note_combine_step"),
        (_REP, "ReplicaGroup._note_reads"),
        (_REP, "ReplicaGroup._note_fenced"),
        (_REP, "ReplicaGroup._note_quorum"),
    ],
)
