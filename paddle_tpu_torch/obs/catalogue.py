"""The metric & span catalogue — the observability plane's public contract.

Every metric the built-in instrumentation emits is declared here with its
kind and meaning. Names are API: dashboards, alerts and tests key on them,
so renaming one is a breaking change. ``python -m paddle_tpu_torch lint`` runs the ``L005``
metric-naming lint (analysis/lints.py) over this table, and
tests/test_obs.py asserts the table itself stays convention-clean.

Kinds: ``counter`` (monotonic, suffix ``_total``), ``gauge`` (point-in-time,
no reserved suffix), ``histogram`` (distributions, suffix ``_seconds`` /
``_bytes``). Metrics whose emitter attaches labels declare them as a third
tuple element — the ``L005`` lint checks those label keys for unbounded
cardinality (a raw path or task payload as a label value would explode the
series space); the merged cluster view additionally tags every pushed
series ``worker=<id>``.

Span names (exported to Chrome trace_event; nesting by same-thread
containment, cross-process parenting by the spans' ``remote`` wire
context) are catalogued in :data:`SPANS`.
"""

from __future__ import annotations

from typing import Dict, Tuple

#: name -> (kind, help[, labels]). Keep sorted by subsystem;
#: the JAX package's observability design notes renders this table verbatim.
CATALOGUE: Dict[str, Tuple[str, ...]] = {
    # -- ckpt: trainer/checkpoint.py ------------------------------------
    "ckpt.saves_total": ("counter", "checkpoint pass dirs published"),
    "ckpt.bytes_total": ("counter", "member payload bytes written"),
    "ckpt.write_seconds": ("histogram", "per-member write (incl. fsync)"),
    "ckpt.fsync_seconds": ("histogram", "per-fsync (file + dir) duration"),
    "ckpt.rename_seconds": ("histogram", "atomic publish rename duration"),
    # -- data: data/reader.py, data/prefetch.py, data/chunks.py ---------
    "data.queue_depth": ("gauge", "prefetch queue occupancy at consume; "
                                  "with several concurrent streams the "
                                  "value is the last-sampled stream's and "
                                  "high_water is the process-wide peak"),
    "data.starved_total": ("counter", "consumer found the prefetch queue "
                                      "empty after warm-up (producer "
                                      "behind)"),
    "data.timeouts_total": ("counter", "prefetch watchdog timeouts raised"),
    "data.prefetch_iters_total": ("counter", "DoubleBuffer iterations "
                                            "started"),
    "data.tasks_total": ("counter", "cloud_reader chunk tasks streamed"),
    "data.task_failures_total": ("counter", "chunk tasks reported failed "
                                            "to the master"),
    "data.retries_total": ("counter", "cloud_reader idle-poll retries"),
    "data.giveups_total": ("counter", "cloud_reader starvation deadlines"),
    "data.backoff_seconds_total": ("counter", "total poll backoff slept"),
    # -- decode: models/transformer.py generate_fused, serving/ -------
    "decode.dispatches_total": ("counter", "compiled decode-step programs "
                                           "dispatched from the host (ONE "
                                           "serves a whole token / segment "
                                           "/ verify span — the fused-"
                                           "decode contract), labels: "
                                           "route", ("route",)),
    "decode.tokens_total": ("counter", "tokens emitted by decode loops "
                                       "(generate_fused / continuous "
                                       "batching / speculative), labels: "
                                       "route", ("route",)),
    "decode.spec_proposed_total": ("counter", "draft tokens proposed to "
                                              "speculative verify"),
    "decode.spec_accepted_total": ("counter", "proposed tokens the "
                                              "target's verify accepted "
                                              "(acceptance rate = "
                                              "accepted/proposed)"),
    # -- faults: faults/inject.py ---------------------------------------
    "faults.injected_total": ("counter", "faults fired, labels: site, "
                                         "action — a chaos run is "
                                         "self-describing",
                              ("site", "action")),
    # -- fluid: fluid/executor.py ---------------------------------------
    "fluid.runs_total": ("counter", "Executor.run invocations"),
    "fluid.cache_hits_total": ("counter", "compiled-fn cache hits, labels: "
                                          "bucketed (was the feed padded "
                                          "by a BucketSpec)", ("bucketed",)),
    "fluid.cache_misses_total": ("counter", "compiled-fn cache misses "
                                            "(trace+compile paid), labels: "
                                            "bucketed", ("bucketed",)),
    "fluid.cache_evictions_total": ("counter", "LRU evictions from the "
                                               "bounded compiled-fn cache"),
    "fluid.cache_size": ("gauge", "live entries in the compiled-fn cache "
                                  "(bounded by Executor cache_capacity)"),
    "fluid.donated_bytes_total": ("counter", "persistable bytes handed to "
                                             "the run as donated static "
                                             "buffers (updated in place, "
                                             "no second copy)"),
    "fluid.placed_bytes_total": ("counter", "persistable bytes device_put "
                                            "onto the executor's mesh per "
                                            "the resolved layout (init / "
                                            "load / restore placement)"),
    "fluid.param_bytes_per_device": ("gauge", "per-device share of the "
                                              "persistable footprint under "
                                              "the resolved shardings "
                                              "(replicated would equal "
                                              "param_bytes_global)"),
    "fluid.param_bytes_global": ("gauge", "total persistable bytes the "
                                          "mesh executor holds (the "
                                          "replicated footprint)"),
    "fluid.fused_regions_total": ("counter", "certified fusion groups "
                                             "activated into single fused "
                                             "dispatch regions (counted "
                                             "per plan decision, not per "
                                             "run), labels: source (tuned "
                                             "| forced)", ("source",)),
    "fluid.fusion_rejected_total": ("counter", "certified fusion groups "
                                               "REFUSED by the measured-"
                                               "only consult chain "
                                               "(tune/fusion.py), labels: "
                                               "reason (no_entry | stale | "
                                               "invalid_plan | cert_invalid"
                                               " | measured_slower | "
                                               "not_schedulable)",
                                   ("reason",)),
    "fluid.run_seconds": ("histogram", "whole Executor.run duration"),
    "fluid.verify_seconds": ("histogram", "static pre-flight "
                                          "(analysis.check_or_raise)"),
    "fluid.device_flops_total": ("counter", "FLOPs dispatched through "
                                            "cost-instrumented executables "
                                            "(fluid Executor, trainer step, "
                                            "fused decode), counted once a "
                                            "key on meta tensors — the numerator "
                                            "of the derived roofline.mfu"),
    "fluid.device_bytes_total": ("counter", "HBM bytes streamed by cost-"
                                            "instrumented executables: each "
                                            "aten op's input and output "
                                            "bytes plus the registered "
                                            "kernel models (the kernels "
                                            "are opaque to the count) — the numerator "
                                            "of roofline.hbm_bw_util"),
    # -- goodput: obs/goodput.py (trainer / v2 SGD / serving loops) ------
    "goodput.compile_seconds_total": ("counter", "wall seconds inside graph "
                                                 "captures and kernel builds (stolen "
                                                 "from the enclosing "
                                                 "bucket), labels: "
                                                 "component", ("component",)),
    "goodput.host_input_seconds_total": ("counter", "wall seconds waiting "
                                                    "on readers/feeders/"
                                                    "admission assembly, "
                                                    "labels: component",
                                         ("component",)),
    "goodput.device_seconds_total": ("counter", "wall seconds dispatching "
                                                "device work and blocking "
                                                "on its results — the "
                                                "goodput numerator, "
                                                "labels: component",
                                     ("component",)),
    "goodput.host_sync_seconds_total": ("counter", "wall seconds in host-"
                                                   "side result handling "
                                                   "(loss reads, token "
                                                   "collection), labels: "
                                                   "component",
                                        ("component",)),
    "goodput.idle_seconds_total": ("counter", "window wall time no bucket "
                                              "claimed (event handlers, "
                                              "logging, scheduler waits), "
                                              "labels: component",
                                   ("component",)),
    "goodput.ratio": ("gauge", "device_seconds / wall over the open "
                               "window — the goodput fraction, labels: "
                               "component", ("component",)),
    # -- graphs: core/graphs.py (the CUDA graph capture hook) -----------
    "graphs.captures_total": ("counter", "CUDA graph captures (one per "
                                         "GraphCache key, the port's "
                                         "counterpart of an XLA compile)"),
    "graphs.capture_seconds": ("histogram", "wall seconds of a key's first "
                                            "call: its eager run plus the "
                                            "capture"),
    # -- kernels: ops/cuda_kernels.py, ops/rnn.py entry points ----------
    "kernels.bytes_total": ("counter", "modeled HBM bytes streamed by "
                                       "the hand kernels' reads, one "
                                       "increment per launch (eager "
                                       "launches count directly; launches "
                                       "inside a CUDA graph are recorded "
                                       "at capture and re-emitted per "
                                       "replay; "
                                       "decode: live cache rows, halved "
                                       "under int8 KV), labels: kernel",
                            ("kernel",)),
    "kernels.routes_total": ("counter", "auto-route decisions at the "
                                        "kernel entry points; counted when "
                                        "the routing Python runs, and "
                                        "again on every replay of a graph "
                                        "that captured it, labels: "
                                        "kernel, route",
                             ("kernel", "route")),
    # -- lease: runtime/coord.py, runtime/lease.py ----------------------
    "lease.renews_total": ("counter", "lease renewals attempted"),
    "lease.renew_failures_total": ("counter", "renewals the server "
                                              "refused (lost lease)"),
    # -- master: runtime/master_service.py (MasterServer._dispatch) -----
    "master.requests_total": ("counter", "master RPCs dispatched through "
                                         "the PYTHON control plane (obs "
                                         "ops via the native fallback + "
                                         "in-process calls; the C++ data "
                                         "plane serves get_task et al. "
                                         "uncounted), labels: type",
                              ("type",)),
    "master.request_errors_total": ("counter", "Python-dispatched master "
                                               "RPCs answered with an "
                                               "error (or raising), "
                                               "labels: type", ("type",)),
    "master.obs_workers": ("gauge", "distinct workers whose metric "
                                    "snapshots the master currently holds"),
    # -- cluster: runtime/membership.py, trainer/elastic.py -------------
    "cluster.members": ("gauge", "workers currently registered under a "
                                 "live heartbeat lease (the elastic "
                                 "fleet size)"),
    "cluster.epoch": ("gauge", "membership view epoch — bumps on every "
                               "join / graceful leave / eviction; elastic "
                               "submissions stamped with an older epoch "
                               "are fence-refused"),
    "cluster.joins_total": ("counter", "mbr_join registrations accepted "
                                       "(incl. re-joins after eviction or "
                                       "a master restart)"),
    "cluster.leaves_total": ("counter", "members removed from the view, "
                                        "labels: reason (graceful = "
                                        "mbr_leave; evicted = missed "
                                        "heartbeat window; replaced = a "
                                        "newer same-name incarnation "
                                        "joined over a live one)",
                             ("reason",)),
    "cluster.heartbeats_total": ("counter", "membership heartbeats "
                                            "accepted (lease extended)"),
    "cluster.stale_rpcs_total": ("counter", "membership/elastic RPCs "
                                            "fence-refused with a "
                                            "structured code, labels: "
                                            "code (stale_epoch | "
                                            "stale_member | "
                                            "unknown_member | "
                                            "stale_step)", ("code",)),
    "cluster.resyncs_total": ("counter", "elastic-worker state refetches "
                                         "(+ re-placement onto the local "
                                         "mesh/layout) at an epoch or "
                                         "step barrier"),
    "cluster.rebucket_tasks_total": ("counter", "in-flight shard tasks "
                                                "requeued off a departed "
                                                "member at an epoch bump "
                                                "(ahead of the timeout "
                                                "re-dispatch)"),
    # worker labels below are BOUNDED by the fleet size (membership-leased
    # worker names), the same contract as the merged-registry worker tag
    "cluster.shard_seconds": ("histogram", "worker-reported shard gradient "
                                           "wall time per accepted "
                                           "ela_grad (the straggler "
                                           "score's raw feed), labels: "
                                           "worker (bounded: fleet size)",
                              ("worker",)),
    "cluster.health_straggler_score": ("gauge", "derived: worker median "
                                                "shard latency / the OTHER "
                                                "workers' median (leave-"
                                                "one-out) over the health "
                                                "window (>2 for 2+ "
                                                "evaluations = straggler), "
                                                "labels: worker (bounded)",
                                       ("worker",)),
    "cluster.health_goodput_ewma": ("gauge", "derived: exponentially-"
                                             "weighted goodput.ratio over "
                                             "the worker's windowed "
                                             "history, labels: worker "
                                             "(bounded)", ("worker",)),
    "cluster.health_heartbeat_jitter": ("gauge", "derived: stddev of the "
                                                 "worker's heartbeat "
                                                 "arrival intervals "
                                                 "(seconds) over the "
                                                 "health window, labels: "
                                                 "worker (bounded)",
                                        ("worker",)),
    "cluster.backlog_per_worker": ("gauge", "autoscale input at each "
                                            "mbr_view: (todo + pending "
                                            "tasks) / live members — the "
                                            "windowed series hysteresis "
                                            "reads"),
    "cluster.autoscale_signal": ("gauge", "the tentative autoscale action "
                                          "recorded per mbr_view "
                                          "(join=1, hold=0, leave=-1); a "
                                          "recommendation only commits "
                                          "when the signal held for the "
                                          "whole hysteresis window"),
    "cluster.autoscale_committed": ("gauge", "the last autoscale action "
                                             "the fleet actor COMMITTED "
                                             "(spawn=1, drain/evict=-1) — "
                                             "diverges from "
                                             "cluster.autoscale_signal "
                                             "exactly while hysteresis or "
                                             "cooldowns hold the fleet "
                                             "still"),
    "cluster.actor_actions_total": ("counter", "committed fleet-actor "
                                               "actions journaled via "
                                               "act_report, labels: "
                                               "population, action (both "
                                               "bounded)",
                                    ("population", "action")),
    "cluster.actor_failures_total": ("counter", "fleet-actor actions that "
                                                "failed: spawns that died "
                                                "or never joined within "
                                                "grace, drains escalated "
                                                "to kill, labels: action "
                                                "(bounded)", ("action",)),
    # -- alerts: obs/alerts.py (the fleet alert engine) ------------------
    "alerts.fired_total": ("counter", "alert rules transitioning to "
                                      "firing, labels: rule (bounded: "
                                      "the declared rule set)", ("rule",)),
    "alerts.resolved_total": ("counter", "alert rules transitioning back "
                                         "to resolved, labels: rule "
                                         "(bounded)", ("rule",)),
    "alerts.active": ("gauge", "alert series currently firing across "
                               "the whole rule set"),
    # -- coord: runtime/coord.py (CoordServer._dispatch) ----------------
    "coord.requests_total": ("counter", "coord RPCs dispatched, "
                                        "labels: type", ("type",)),
    "coord.request_errors_total": ("counter", "coord RPCs answered with "
                                              "an error (or raising), "
                                              "labels: type", ("type",)),
    # -- mesh: fluid/executor.py (GSPMD sharding plane) -----------------
    "mesh.axis_size": ("gauge", "devices along each mesh axis, "
                                "labels: axis", ("axis",)),
    "mesh.axis_utilization": ("gauge", "fraction of the persistable "
                                       "footprint actually sharded over "
                                       "each axis (1.0 = every parameter "
                                       "byte divides along it), labels: "
                                       "axis", ("axis",)),
    # -- obs: obs/aggregate.py (worker-side pusher) ---------------------
    "obs.pushes_total": ("counter", "registry snapshots pushed to the "
                                    "master (obs_push RPC)"),
    "obs.push_failures_total": ("counter", "obs_push RPCs that failed "
                                           "(master unreachable)"),
    # -- roofline: obs/roofline.py (the device cost ledger) --------------
    "roofline.mfu": ("gauge", "derived model-FLOPs utilization over the "
                              "most recent accounting window: "
                              "fluid.device_flops_total delta / elapsed / "
                              "chip dense peak (set only when the peak is "
                              "known — on the H100 row or "
                              "under PADDLE_TPU_PEAK_TFLOPS; updated on "
                              "dispatch, so an idle chip HOLDS its last "
                              "busy window's value — cross-check the "
                              "counter deltas for liveness)"),
    "roofline.hbm_bw_util": ("gauge", "derived HBM-bandwidth utilization "
                                      "over the most recent accounting "
                                      "window: fluid.device_bytes_total "
                                      "delta / elapsed / chip HBM peak "
                                      "(null + staleness semantics as "
                                      "roofline.mfu)"),
    "roofline.cost_analysis_failures_total": ("counter", "meta-tensor cost "
                                                         "counts that "
                                                         "raised — derived "
                                                         "FLOPs/bytes for "
                                                         "those executables "
                                                         "are honest "
                                                         "unknowns, not "
                                                         "quiet nulls"),
    # -- rpc: runtime/master_service.py (_RpcClient, shared by coord) ---
    "rpc.calls_total": ("counter", "RPC calls issued, labels: rpc, op",
                        ("rpc", "op")),
    "rpc.call_seconds": ("histogram", "end-to-end call latency incl. "
                                      "retries, labels: rpc", ("rpc",)),
    "rpc.retries_total": ("counter", "retry attempts across clients"),
    "rpc.giveups_total": ("counter", "retry budgets exhausted"),
    "rpc.backoff_seconds_total": ("counter", "total backoff delay slept"),
    # -- serving: serving/engine.py, serving/paged.py -------------------
    # tenant labels are BOUNDED by contract: values are charset-validated
    # at submit (serving/batcher.py TENANT_RE) and the engine caps the
    # number of distinct tenants it mints series for (max_tenants,
    # default 32 — the L005 live-sample cardinality ceiling)
    "serving.requests_total": ("counter", "requests finished, labels: "
                                          "outcome (length | eos | "
                                          "cancelled | timeout | error — "
                                          "error = the engine failed and "
                                          "abandoned it), tenant "
                                          "(bounded; see above)",
                               ("outcome", "tenant")),
    "serving.rejected_total": ("counter", "submissions refused structured "
                                          "at admission, labels: reason "
                                          "(overloaded = queue cap; "
                                          "draining = shutdown gate)",
                               ("reason",)),
    "serving.queue_depth": ("gauge", "requests waiting for a slot (the "
                                     "admission queue)"),
    "serving.slots_live": ("gauge", "slots holding an in-flight request"),
    "serving.pages_used": ("gauge", "KV-cache pages currently allocated "
                                    "out of the pool"),
    "serving.pages_reserved": ("gauge", "pages reserved by admitted "
                                        "requests (worst-case; >= used)"),
    "serving.page_occupancy": ("gauge", "live tokens / allocated page "
                                        "capacity — 1.0 means HBM holds "
                                        "only live tokens (the paged-"
                                        "cache residency win). The "
                                        "prefix cache moves it BOTH "
                                        "ways: N readers over one "
                                        "shared page push it past 1.0, "
                                        "while retained COLD cache "
                                        "pages sit in the denominator "
                                        "and drag a lightly-loaded "
                                        "warm daemon toward 0 — low "
                                        "occupancy + high prefix_pages "
                                        "is healthy retention, not a "
                                        "leak"),
    "serving.prefix_hits_total": ("counter", "admissions that matched the "
                                             "prefix radix index and "
                                             "prefilled only their "
                                             "non-shared suffix, labels: "
                                             "tenant (bounded; see above)",
                                  ("tenant",)),
    "serving.prefix_misses_total": ("counter", "admissions that found no "
                                               "shared prefix and ran the "
                                               "full prefill, labels: "
                                               "tenant (bounded)",
                                    ("tenant",)),
    "serving.prefix_pages_shared": ("gauge", "prefix-index pages pinned "
                                             "by >= 1 live request (a "
                                             "page read by N requests "
                                             "counts once — the "
                                             "refcounted-sharing win)"),
    "serving.prefix_evictions_total": ("counter", "cold prefix-cache "
                                                  "entries evicted back "
                                                  "to the free list "
                                                  "(lowest decayed "
                                                  "measured-reuse score "
                                                  "first)"),
    "serving.ttft_seconds": ("histogram", "submit -> first token (queueing "
                                          "+ prefill) — the SLO pair's "
                                          "first half, labels: tenant "
                                          "(bounded)", ("tenant",)),
    "serving.tpot_seconds": ("histogram", "per-output-token time after "
                                          "the first (completion - first "
                                          "token) / (n - 1), labels: "
                                          "tenant (bounded)", ("tenant",)),
    # disaggregation: KV-page shipping (serving/ship.py wire contract)
    "serving.ship_pages_total": ("counter", "KV pages exported for "
                                            "shipping to a decode worker "
                                            "(prefill side, "
                                            "PagePool.export_slot)"),
    "serving.ship_bytes_total": ("counter", "payload bytes exported for "
                                            "shipping (pre-chunking, "
                                            "pre-base64)"),
    "serving.ship_chunks_total": ("counter", "wire chunks emitted on the "
                                             "ship send edge (post-"
                                             "chunking; what the ship "
                                             "phase's timeline duration "
                                             "is spent on)"),
    "serving.ship_chunk_bytes_total": ("counter", "raw chunk bytes on the "
                                                  "ship send edge (post "
                                                  "srv.ship fault filter, "
                                                  "pre-base64)"),
    # per-request timelines (obs/requests.py): the phase label is the
    # BOUNDED attributed-phase enum (queued/scheduled/prefill/ship/adopt/
    # decode), never a request key — L005-safe by construction
    "serving.phase_seconds": ("histogram", "per-request phase durations "
                                           "from the timeline ledger; the "
                                           "per-request phase sum "
                                           "reconciles with observed "
                                           "TTFT + decode wall (docs/"
                                           "design/observability.md "
                                           "'Request timelines'), labels: "
                                           "phase (bounded enum)",
                              ("phase",)),
    "serving.exemplars_total": ("counter", "slowest-K timeline exemplars "
                                           "captured by the aggregator's "
                                           "request store, labels: phase "
                                           "(the exemplar's dominant "
                                           "phase, bounded enum)",
                                ("phase",)),
    "serving.adopted_total": ("counter", "shipped slots adopted into this "
                                         "pool (decode side, "
                                         "PagePool.adopt_slot) — each is "
                                         "one cross-worker request "
                                         "landing"),
    "serving.adopt_refused_total": ("counter", "shipments refused instead "
                                               "of adopted, labels: reason "
                                               "(chunk = per-chunk CRC/"
                                               "base64 damage; data_loss "
                                               "= reassembled payload "
                                               "failed verification; "
                                               "no_chunks = adopt with no "
                                               "chunks held; geometry = "
                                               "pool page_block/kv_dtype "
                                               "mismatch; evicted = half-"
                                               "shipment evicted by the "
                                               "reassembly cap)",
                                    ("reason",)),
    # -- router: serving/router.py (`paddle_tpu route`) ------------------
    "router.requests_total": ("counter", "client submits the router "
                                         "resolved, labels: outcome (ok | "
                                         "overloaded = every decode pool "
                                         "refused | unavailable = no "
                                         "worker reachable | "
                                         "invalid_argument)",
                              ("outcome",)),
    "router.reroutes_total": ("counter", "in-flight requests re-placed "
                                         "on another worker, labels: "
                                         "reason (evicted = membership "
                                         "TTL eviction; left = graceful "
                                         "leave; unreachable = poll "
                                         "transport failure; not_found = "
                                         "worker restarted and forgot "
                                         "the stream; error = engine "
                                         "failed mid-stream; lost; "
                                         "prefill_fallback = every "
                                         "prefill worker down, decode-"
                                         "side prefill served instead)",
                              ("reason",)),
    "router.inflight": ("gauge", "router-tracked requests not yet done "
                                 "(buffers still growing or awaiting "
                                 "collection)"),
    "router.workers": ("gauge", "serving workers live in the router's "
                                "membership table, labels: role (decode "
                                "| prefill)", ("role",)),
    # -- tune: tune/driver.py (`paddle_tpu tune`) -----------------------
    "tune.measurements_total": ("counter", "candidate-plan timings taken "
                                           "by the autotune loop (one "
                                           "per timed dispatch), labels: "
                                           "space",
                                ("space",)),
    "tune.ledger_seeded_families_total": ("counter",
                                          "plan families swept because a "
                                          "profile ledger implicated "
                                          "their space (`paddle_tpu tune "
                                          "--from-ledger`)"),
    # -- trainer: trainer/trainer.py ------------------------------------
    "trainer.steps_total": ("counter", "train batches executed"),
    "trainer.examples_total": ("counter", "samples consumed (leading dim "
                                          "of the first batch array)"),
    "trainer.step_seconds": ("histogram", "batch step: device dispatch + "
                                          "host block on the result"),
    "trainer.sync_seconds": ("histogram", "host block on the step result "
                                          "(device time shows up here "
                                          "under async dispatch)"),
    "trainer.nonfinite_total": ("counter", "non-finite losses observed"),
    "trainer.skipped_total": ("counter", "batches dropped by "
                                         "on_nonfinite=skip"),
    "trainer.preemptions_total": ("counter", "preemption checkpoints "
                                             "taken (SIGTERM/SIGINT)"),
}

#: span names the built-in instrumentation emits (Chrome trace contract)
SPANS: Dict[str, str] = {
    "trainer.pass": "one pass of the train loop (args: pass_id)",
    "trainer.step": "one batch step (device dispatch + host sync)",
    "trainer.device_step": "the graphed step call (dispatch)",
    "trainer.host_sync": "host block on the loss value",
    "trainer.checkpoint": "pass/preemption/halt checkpoint save "
                          "(args: pass_id, reason)",
    "fluid.run": "Executor.run",
    "fluid.verify": "static pre-flight over the Program",
    "rpc.call": "one RPC incl. retries (args: rpc, op); its (trace_id, "
                "span_id) rides the request envelope as wire context",
    "master.dispatch": "server-side handling of one master RPC (args: op; "
                       "remote = the client's rpc.call span)",
    "coord.dispatch": "server-side handling of one coord RPC (args: op; "
                      "remote = the client's rpc.call span)",
    "serving.prefill": "one admission batch: ragged prefill + page "
                       "placement (args: batch)",
    "serving.segment": "one batched decode segment across live slots "
                       "(args: live)",
    "serving.ship": "client side of one KV shipment: every srv_ship chunk "
                    "RPC for one request (args: xid, bytes, key)",
    "srv_ship": "decode-side landing of one ship chunk (args: xid, seq; "
                "remote = the prefill worker's rpc.call span — the "
                "prefill->decode hop's flow arrow)",
    "srv_adopt": "decode-side adoption of a reassembled shipment into the "
                 "engine (args: xid, key; remote = the prefill worker's "
                 "rpc.call span)",
    "ckpt.publish": "atomic pass-dir publication (args: pass_id)",
    "ckpt.member": "one member write+fsync (args: member, bytes)",
    "ckpt.fsync": "file or directory fsync",
    "ckpt.rename": "tmp -> final rename swap",
}


#: JAX's entries whose emitters live in modules the port has not taken,
#: by the module that emits them: none since the tune and elastic planes
#: came across. An entry here is held out of CATALOGUE and SPANS, so that
#: L007 (analysis/lints.py) holds the port's tree to exactly what it emits.
WAITING_MODULES: Dict[str, Tuple[str, ...]] = {}

#: name -> the entry JAX's catalogue gives it, for every name of
#: :data:`WAITING_MODULES`
WAITING: Dict[str, object] = {
    name: (CATALOGUE.pop(name) if name in CATALOGUE else SPANS.pop(name))
    for names in WAITING_MODULES.values() for name in names}
