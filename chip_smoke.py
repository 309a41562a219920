"""On-card smoke test of the PyTorch/CUDA port (k8s_dra_driver_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA Hopper
card:

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

1. device: require CUDA, print the card's name and power limit, turn
   TF32 off;
2. build the CUDA kernels from ``k8s_dra_driver_tpu_torch/csrc`` with
   nvcc (sm_90a) and print the build time;
2b. the driver's device layer on the live card (``phase_driver``):
   (a) ``SysfsBackend("/")`` and the C++ shim's ``NativeBackend("/")``
   (built from ``k8s_dra_driver_tpu_torch/native`` into
   ``build/native/``) give equal topologies, whose cards agree with
   ``nvidia-smi`` (count, name, memory, ``nvidia-smi -q``'s minor
   numbers; its UUIDs, and its bus ids where it has them) and with
   ``torch.cuda`` (count, each UUID, bus id and name), every device node
   present, generation ``h100``, no card unhealthy; (b) the device
   model publishes one chip and one core a card, no slice on one card,
   the chip's ``uuid`` CUDA's and its ``hbm`` the card's memory
   (``total_memory`` at most it and at least 95% of it); (c) a claim
   for one chip by CEL on ``productName`` is allocated by the Python
   and the native engine to the same device, and a claim for that
   chip's core is refused by both with one message (shared token); (d)
   a child ``python3`` under ``CUDA_VISIBLE_DEVICES=<the allocated
   uuid>`` sees one card with that UUID and runs K1 against its plain
   version at phase 3's tolerance (its launches are not counted);
2c. the port's kubelet plugin on the live card (``phase_plugin``):
   ``cmd/plugin.py``'s ``run`` on a thread with ``--fake-cluster``,
   ``--discovery auto`` and its gRPC services on short ``/tmp``
   sockets: (a) the published ResourceSlice holds a chip and a core
   device a card with CUDA's UUID and product name, registration
   ``GetInfo`` names ``tpu.google.com`` and the plugin socket, the
   standard CDI spec validates and every device node and mount source
   in it exists; (b) a claim the port's allocator gave the card is
   prepared by ``NodePrepareResources`` over gRPC, its claim spec
   carries ``CUDA_VISIBLE_DEVICES=<uuid>`` alone, and a child started
   with the merged edits of both specs (this script's CDI interpreter
   plays the runtime: env applied, nodes and mount sources checked)
   sees one card with that UUID and runs K1 against its plain version
   at phase 3's tolerance (``driver_child``; its launches are not
   counted); (c) ``run`` stopped and started again on the same plugin
   root: the checkpoint holds the claim, a second prepare gives the
   same CDI ids without writing the spec, and ``NodeUnprepareResources``
   removes the spec and empties the checkpoint; (d) a time-sliced claim
   (policy file, ``TPU_RUNTIME_PREEMPTION_MS``, the timeshare mount)
   prepares and its unprepare resets the policy; (e) ``HealthMonitor``
   on the live backend sees no change, and a backend reporting the card
   failed republishes the slice without it, then with it again, the
   listeners told each time; the phase wall and the gRPC latencies
   (host clock) printed;
2d. the port's controller and coordination on the live card
   (``phase_coordination``), the port's plugin on a thread as in 2c,
   this script playing the kubelet of coordinator Deployments (each one
   the plugin creates runs as a real ``python -m
   k8s_dra_driver_tpu_torch.cmd.coordinatord`` process with the rendered
   args, container paths mapped to host paths; ready once its ready
   file exists; stopped when the Deployment goes): (a)
   ``cmd/controller.py``'s ``run`` on a thread over the same cluster: a
   node labelled ``tpu.google.com/slice=<id>.2x2`` gets its pool (1
   ``podslice`` and 128 ``channel-*`` devices), unlabelled it goes,
   ``stop`` cleans up, and the card's own node, which has no label,
   gets none; (b) a Coordinated claim (duty cycle 100%, the node's
   time-slicing policy file giving a 1000 ms cycle) prepared over gRPC,
   its daemon a real process; two children under ``python -m
   k8s_dra_driver_tpu_torch.coordclient.gate exec`` with the claim's
   edits each loop K1 at phase 3's main-path shape in stamped batches:
   both progress, every batch completed while both ran lies in its own
   window plus one batch and the gate's 0.25 s, K1 within phase 3's
   tolerance of its plain version, status.json lists both workers and
   no violation other than this script's own process (which holds a
   CUDA context, reported on the card's ``/dev/nvidia<minor>``), and a
   third, ungated child that opens the card is reported as an
   ``unregisteredDeviceHolder`` of that node; (c) a Coordinated claim
   with a 4 GiB limit: a child whose ``PYTORCH_CUDA_ALLOC_CONF`` came
   from its budget before torch started allocates 2 GiB and gets
   ``torch.cuda.OutOfMemoryError`` for 6 GiB, and, its cap lifted,
   reports ``memory_reserved()`` above the limit, which status.json
   shows as a violation (action ``report``); (d) two time-sliced claims
   (interval Long, 20 ms) on the card, each child under the gate with
   the card's UUID in ``CUDA_VISIBLE_DEVICES`` (one lock,
   ``<uuid>.lock``): the two children's uninterrupted K1 batches
   overlap by no more than one batch in all; (e) a Coordinated claim
   whose env a child takes: the 154M paged engine in bf16 at full
   width and depth, 4 greedy requests of 16 new tokens through a
   ``FleetGateway`` whose ``ReplicaManager`` leases with
   ``DraChipLease(env, mounts)``: the replica's label is the card's
   UUID, its registration exists and heartbeats while it serves, its
   tokens equal the same engine's without a lease, K1 and K2 launch,
   its registration is gone after ``retire``; a replica added and the
   card reported failed by the health source (the live backend's view
   mapped to UUIDs) drains it.  The K1 children's loop launches and the
   leased replica's K1 and K2 join the kernels line; the phase wall,
   the batch counts and window shares, the OOM, the overlap and the
   replica's tokens/s are printed with the card and its power limit;
2e. the H100 demo specs on the live card (``phase_demo``, in a process
   of its own beside the serving phases, :class:`PhaseChild`): the port's
   plugin on a thread as in 2c over a fake cluster, this script playing
   the claim controller, the scheduler (the port's allocator), the
   kubelet (gRPC prepare, CDI applied; coordinator Deployments run as
   in 2d) and the container runtime: each ``demo/specs/h100/`` spec is
   applied (its claims created), each pod's claim scheduled and
   prepared, every CDI device node checked present, and each container
   run as a child process under this process's environment without
   ``CUDA_VISIBLE_DEVICES``, with the claim's CDI env (container paths
   of its mounts mapped to host paths); each container's first line
   names the claim's card and torch.cuda shows that one card.
   tpu-test1: pod2's claim refused while pod1 holds the one card, then
   given the same card; tpu-test2/3 and the coordinated specs: the
   containers sharing a claim run at once on one UUID; the enforced
   pods run under ``python -m k8s_dra_driver_tpu_torch.coordclient.gate
   exec``, the coordinator's schedule lists both, each counts ticks;
   tpu-test5 (two cards) refused on one card; tpu-test6 allocated by its
   CEL selector; the serve pod's ``decode_probe`` and ``serving_probe``
   valid on the card at the widths ``DEMO_SERVE_K1`` names (phase 3
   holds K1 at each of the pod's prefill shapes), their K1 launches
   (tensor-core route) joining the kernels line.  Every container's
   output, each claim-created ->
   first-line latency and their p50 (host clock, a reading) and the serve
   pod's tokens/s are printed with the card and its power limit;
3. K1 (flash-attention forward) against its plain PyTorch version at
   the serving path's shapes (the demo serve pod's among them) and the
   training shape, with timings and
   the card's bound: bf16 on the tensor-core route, its output before
   the final rounding held to ``flash_forward_reference`` (which rounds
   q and p where the TPU kernel does, per key tile of the kernel) and
   more loosely to the f32 oracle ``attention_forward``; f32 on the
   CUDA-core route.  Phases 3-5 also hold each kernel at the small head
   dims of the JAX package's probe models (D = 8, 16 and 32,
   ``SMALL_DIMS``) in both dtypes and every GQA group K2 has, at the
   same gates, and time it at a shape a reference-width probe gives it
   (the kernels line's ``small_d`` rows); the main paths' launches at
   those dims (the probes below, at their reference defaults) are the
   line's ``small_d_launches``, gated per SMALL_D_REQUIRED;
3b. K1's block entry (``flash_block_attention``: q against one K/V
   block at absolute offsets, Tq != Tk, q/k segments, the unnormalized
   statistics o, m, l) on both routes, D = 64, 128, 8, 16, 32, against
   ``flash_block_attention_reference`` at a ring's offset pairs (full
   block, diagonal, a block wholly above the diagonal whose rows must
   come out m = -1e30, l = 0, o = 0 exactly, a window crossing the
   block, 192 x 320, distinct q/k segments); S = 4 hops merged with
   ``merge_flash_stats`` against the normalized K1; times at the ring's
   hop shape (B=8 Tq=Tk=1024 H=16 Hkv=4 D=64 bf16, diagonal and full)
   beside the bound, the plain version and SDPA (a yardstick);
4. K2 (paged decode) likewise, with each case's plan (splits, blocks)
   printed, a bitwise repeat of every case, rows over several splits
   (the merge) required and the merge's counters back at 0; also at
   one tp=2 rank of the 154M (8 query and 2 KV heads, both dtypes) on
   the tables of multichip (b) and of (e)'s paged engine, each at the
   plan its run launches: the kernels line's ``tp_rank`` rows of K2,
   as phase 3's K1 rows at the rank's prefill and engine fills (B=8
   and B=1, T=24-96) and phase 14's K7a rows at the rank's shards;
5. K3 (flash backward dq) and K4 (dk/dv) against their plain version
   at the training shape (B=8 T=2048 H=16 Hkv=4 D=64 bf16 causal), with
   a window, segments, D=128, f32 and two ring-style blocks (offsets,
   Tq != Tk, a valid-key end): bf16 on the tensor-core route against
   ``flash_block_grads_reference`` and, more loosely, against the f32
   oracle ``attention_block_grads``; f32 on the CUDA-core route against
   the oracle;
6. K5 (grouped matmul, plain and transposed read) and K6 (its dw)
   against ``gmm_reference`` / ``gmm_dw_reference`` at the moe_heavy
   shapes (18,432 static rows, 16 experts, d 512, f 4096, both expert
   matrices), in bf16 (K5 and K6 on the tensor-core route; bf16 K6's
   bf16 output, the backward's form, must equal its f32 output
   rounded) and f32 (the CUDA-core route), over four group layouts
   (the router's own, one hot expert, empty experts, a long dead
   tail), with timings (K6 also at the hot expert), the bound from the
   live rows and ``torch._grouped_mm`` as the library yardstick, held
   to the plain version too;
7. the serving engine, contiguous KV, at the full width of the 154M
   configuration (vocab 32000, d_model 1024, 8 layers, 16 heads, 4 KV
   heads, d_ff 4096, max_seq 2048, bf16, random weights from a fixed
   generator) draining the s8_r24 traffic (8 slots, 24 requests,
   prompt lengths 96/48/72/24, max_new 48, four of them sampled);
   every greedy stream is held to a teacher-forced pass of
   ``forward``;
8. the same with the paged KV layout and the paged kernel, then once
   more on a pool small enough to force preemption;
9. training, small: one f32 AdamW step of a 2-layer config on the card
   (kernels; K1/K3/K4 on their f32 route) and on the CPU (plain
   versions), loss and parameters compared;
10. training, full width: the 154M configuration, 6 AdamW steps of
    B=8 x T=2048 over a repeated-motif token file read by
    ``BatchLoader``; losses finite and falling, every K1, K3 and K4
    launch on the tensor-core route (8 each per step); a checkpoint at
    step 3 restored into a fresh state must equal the saved state
    bitwise and resume to losses within
    RESUME_TOL of the uninterrupted run; one step under remat launches
    K1 twice per layer;
10b. training recovery (``phase_gang_recovery``): the 154M supervised
    by ``GangSupervisor`` over ``ElasticTrainJob(chips=4)``, every dp
    row of a step its own forward and backward: (a) the kill arc of
    the JAX package's supervisor test in bf16 (dp 4 -> 2, restored
    step 4, the transitions, steps once, the contract, the metrics,
    K1/K3/K4 exactly n_layers x the rows of each step; MTTR, each
    sharded generation's bytes, save ms and MiB/s, the restore ms and
    the steady step walls at dp=4 and dp=2 printed), (b) a wedged
    worker caught by the step deadline, (c) the kill arc in f32 (the
    154M's widths at 2 layers) within 1e-4 of an uninterrupted run, then a flipped byte: the restore
    falls back a generation and ``read_slice`` raises, (d) a resize, a
    park and an unpark at a checkpoint step: no step lost, no device
    memory held while parked, (e) the recovery, fleet and multi-tenant
    probes on the card at their own defaults (the reference's widths,
    d_head 8, f32), each ``valid``;
10c. the compound-fault crucible (``phase_crucible``, in a process of
    its own beside the serving phases, as 2e): the port's
    ``CrucibleRig`` (a ShardedGateway over a one-prefill, one-decode
    paged, tiered, LoRA pool, two elastic gangs on
    ``ShardedCheckpointer``, the multi-tenant reconciler over an
    8-slot ledger, the burn engine) under the seeded default schedule
    of every fault kind: (a) 88 cycles on the crucible's default
    model, the reference crucible's (d_head 8, f32), every
    assertion of the reference acceptance (no violation, every kind
    fired, >= 3 overlaps, the four window-triggered arcs inside their
    windows, every request finished byte-equal to its oracle, both
    gangs recovered with losses exactly once, no burn alert) and K1,
    K2, K3, K4 launched; (b) the same gates at full width (engines and
    oracles on the 154M in f32, gangs on the 154M's widths at 2 layers in
    bf16, 88 cycles),
    with the generations saved (count, bytes, mean ms) and the
    restores; (c) the spec-fleet schedule run twice, equal injection
    logs, fired cycles, outcomes and tokens, and its repro replayed to
    the same fired cycles;
10d. context parallelism (``phase_sp_train``): two worker processes
    sharing the card over gloo, their group from the rendezvous
    contract; (a) the f32 small ring step over sp=2 and (d) over dp=2
    against one CPU process, (b) 154M ring steps and (c) a Ulysses step
    against phase 10's losses, exact per-rank K1-block/K3/K4 launches;
    (e) a ring peer of the f32 small step SIGSTOPped, then one
    SIGKILLed, after its first step: the survivor exits nonzero within
    50 s, its stderr naming ``MeshPeerError`` and the ``sp`` axis;
11. MoE training, small: one f32 AdamW step of a 2-layer, 4-expert
    gmm config with the router aux losses, card against CPU, every
    parameter (router included) moved, exact K1/K3-K6 launches (K1,
    K3/K4, K5 and K6 on the f32 route);
12. MoE training, full width: moe_heavy (vocab 1024, d_model 512, 4
    layers, 4 heads, d_ff 4096, 16 experts, top_k 2, bf16) with gmm
    dispatch, 6 AdamW steps of B=8 x T=1024 from a token file,
    load-balance weight 0.01; losses finite and falling, exactly 16
    K5, 8 K6 and 4 each of K1, K3, K4 per step, K1, K3-K6 on the
    tensor-core route; three steps repeated
    from the same seed bitwise; one forward under gmm against dense
    dispatch;
13. MoE serving: a contiguous drain of s8_r24 at moe_heavy (served
    with dense dispatch), every greedy stream held to a teacher-forced
    forward under gmm dispatch (K5);
14. K7 (weight-only int8 matmul; K7a ``int8_matmul``, K7b ``int8_bmm``)
    against ``int8_matmul_reference`` / ``int8_bmm_reference`` at the
    154M decode shapes (M = 1, 8, 64), one tp=2 rank's shards of them at
    8 rows (TP_RANK_K7; the unembedding's x a column slice), the 660M
    shapes, off-gate M = 96 and 768, a ragged shape, and moe_heavy's
    expert products (shared x, transposed view), in bf16 (the
    tensor-core route) and f32 (the CUDA-core route), each case's plan
    (K split across blocks) printed, with the device memory cache (L2)
    flushed before every timed call, the bf16 cuBLAS product and
    ``torch._weight_int8pack_mm`` as yardsticks, and the bound;
15. int8 serving at 154M: ``quantize_params`` of the same bf16 weights,
    held to the full-precision logits on one 8 x 96 forward; three
    drains of s8_r24 (contiguous KV, contiguous int8 KV, paged KV), each
    passing the teacher-forced check against a full ``forward`` on the
    same int8 weights (M > 64 there: the einsum route) and launching K7a
    49 times (6 per layer + the unembedding) for each forward pass it
    serves: a whole number of passes, at least the drain's decode steps
    and at most all its forward passes (by dispatch label), every one
    on the tensor-core route;
16. fused generation blocks (``phase_fused_serving``): s8_r24 drained
    on the step engine and at ``chain_steps`` = 47 (the JAX package's
    serving probe), where every block is one replay of a captured CUDA
    graph, for the 154M on bf16 weights, on int8 weights (K7a inside
    the graph) with the contiguous cache and with the int8 KV cache,
    and for moe_heavy in f32: f32 streams byte-equal to the step
    engine's, bf16 ones within the teacher-forced margin (the
    byte-equal count printed), K7a exactly 49 a pass with the graphs'
    passes counted as decode passes, no block outside a graph,
    dispatches plus readbacks per token at least 8x fewer; tokens/s,
    wall ms per decode step and per token beside the step engine's,
    graphs captured and their seconds;
17. speculative decoding (``phase_spec_serving``, ``draft_len`` 4):
    s8_r24 on the 154M with the n-gram source (contiguous step by step
    and at ``chain_steps`` = 47, paged on the full pool and on 41
    blocks, which preempts) and with the target as its own draft (step
    by step and fused, on bf16 and on int8 weights, K7a in the graph
    for target and draft; f32 step by step): every fused block one
    graph replay and its streams byte-equal to the step drain's, K7a
    exactly 49 a target and a draft pass, no K2 and spec trims on the
    paged drains, the f32 self-draft accept rate at least 0.8; each
    drain's tokens/s, wall ms a window, windows, accept rate and
    dispatches plus readbacks a token beside the non-speculative drain
    of the same call; then ``spec_accept_rows`` alone on 16384 rows
    against the closed-form target distribution (total variation), and
    the ported spec-decode probe at its reference config (8 heads of 16
    over 4) in bf16 and f32, byte-equal to its closed-form ramp;
18. multi-adapter LoRA serving (``phase_lora_serving``): s8_r24 on the
    154M with six rank-16 adapters from ``make_adapter`` over a pool of
    four resident slots (base rows and adapter rows in every batch, so
    the drains evict and cold-load), drained contiguous step by step
    and fused, paged (K2), on int8 weights step by step and fused (K7a
    in the graph), with the n-gram source step by step and fused, and in
    f32: every pool buffer at its address after each drain; base rows
    byte-equal to the adapter-less drain of the call; adapter rows
    apart from it; fused byte-equal to step, 24/24; K2 exactly n_layers
    a paged step call, K7a exactly 49 a pass; no capture in a fused
    drain's measured run while it cold-loads; every greedy stream
    within TF_MARGIN teacher-forced (adapter rows through the base
    prefill and an adapter window); in f32 every stream byte-equal to
    one-adapter oracle engines of the same slot count (in bf16
    counted); then the pool's probe at the 154M in bf16 and f32 (switch
    and cold-load times, the churn's hit share) and at its reference
    default (4 heads of 16, f32: byte-equal gated);
18b. disaggregated prefill/decode and the KV tiers
    (``phase_disagg_tiers``): s8_r24 exported by a prefill engine
    (``prefill_export``) and adopted in request order by a decode
    engine (``adopt_block``) for the four layout pairs in bf16 (no K1
    on a decode side, K2 exactly n_layers a paged decode step, greedy
    streams within TF_MARGIN, the count equal to phase 8's unified
    paged drain printed) and paged into paged in f32 (every stream
    byte-equal to a unified f32 paged drain); the tier acceptance arc:
    a 1024-token prefix warmed on a tiered (256 MiB host arena), an
    all-HBM and a recompute paged engine, flushed, then ridden back by
    a wave of 8 requests (32-token suffixes, max_new 32, two sampled):
    tiered streams byte-equal to the all-HBM engine's with no
    ``prefill`` launch and one ``paged_slab_adopt``, the recompute
    twin's within TF_MARGIN; the prefix spilled to a temporary
    directory and promoted by a fresh engine (residency (1024, "disk"),
    streams byte-equal to the all-HBM engine's); the promotion's pieces
    (gather, crc32, adopt, suffix fill) against a full prefill; the
    ported tier probe at the 154M in bf16 and f32 and at its reference
    default (8 heads of 32, f32) (promote and recompute ms; byte-equal
    gated in f32, the churn's hit share above 0);
18c. the fleet (``phase_fleet``): s8_r24 in three bursts of 8 through
    two-replica pools of 8-slot engines, r0 downed through the health
    signal after its first wave: f32 paged (every uid finished exactly
    once, 1 drain, the requeued count, the replacement up, every stream
    byte-equal to one f32 paged engine's, K2 exactly n_layers a paged
    decode step and K1 n_layers a fresh prefill, the gateway's metric
    samples) and bf16 contiguous (exactly once, greedy streams within
    TF_MARGIN teacher-forced, the byte-equal count printed); a
    one-prefill, two-decode f32 paged pool behind ``DisaggRouter``
    (exactly once, byte-equal, 24 migrations in the migrator and the
    metrics, no ``prefill*`` label on a decode replica and no
    ``decode_*`` on the prefill replica, every request finished on a
    decode replica) and its prefill replica downed after the first
    export wave (exactly once, decode-side prefills, byte-equal); the
    gateway and disagg probes at the 154M in bf16 (accounting gated)
    and the disagg probe in f32 (byte-equality gated); same-card
    migration costs of a bf16 [1, 2048] cache and a 96-token slab;
18d. the multi-process gateway (``phase_procfleet``): three pump
    processes, each with its own CUDA context and one 8-slot f32
    contiguous replica of the 154M (``procpump.tiny_model``), behind
    ``ProcessGateway``; s8_r24 in three bursts, the pump holding r0
    SIGKILLed at the cycle after the first burst's dispatch: every uid
    finished exactly once, the outcome journal's replay clean, one pump
    death and requeued outcomes, every stream byte-equal to one f32
    contiguous engine in this process on the same ``tiny_model``
    weights, each survivor's K1 (read over the wire) a positive multiple
    of n_layers on the f32 route; four s8_r24 KV blocks (one sampled)
    exported by one surviving pump and adopted by the other over the
    wire, equal to the oracle (frame bytes and export, encode, pipe,
    decode, adopt, generation ms printed); a bf16 [1, 1024] block of
    the 154M through the wire codec and JSON in this process, every leaf
    bit-equal and its stream equal (encode, JSON and decode ms beside a
    same-card copy); the multi-process scaling probe with null engines
    at 1, 2 and 4 pumps (printed, not gated);
18e. serving observability (``phase_observability``, params made in
    the phase): a 154M bf16 paged engine's ``MemWatch`` ledger against
    the card allocator's rise over its build (``model_params`` +
    ``paged_kv_pool`` equal to the tensors' ``numel x element_size``
    exactly, the rise within LEDGER_TOL of the ledger, source
    ``"device"``), s8_r24 drained through it (teacher-forced, exact K1
    and K2 launches, the ledger unchanged, the allocator's residue
    printed); ``observatory_probe`` at bench.py's tiny request counts
    with the 154M as its engine, then with its reference default
    (``valid``, source ``"device"``, the merged digest count = the
    per-pump sum; ``digest_overhead_x`` printed); ``paged_kv_probe`` at
    the 154M in f32 (``byte_equal``, CoW share > 0, no allocation
    failure, concurrency above contiguous, exact K1 and K2 launches), in
    bf16 (printed) and at its reference default (D = 16, f32: the
    reference's gates, as its tight budget fails allocations by
    design);
18f. the fleet control loop (``phase_fleet_control``): (a)
    ``FleetReconciler`` over f32 paged 154M replicas on allocation
    labels 0-3 of this card, with the burn-rate engine, ``MemWatch`` and
    a tracer: a burst under a tight deadline, calm, a label marked
    unhealthy and healed (exactly once, 24/24 byte-equal to one f32
    paged engine, scale-up, drain-then-retire, the ledger's owners = the
    live replicas' labels every tick, one reap and one heal, MemWatch's
    units = the live replicas every step, a burn-rate alert and none in
    a calm control run, exact K1 and K2 launches; the critical path's
    parts = its wall, ``export_chrome`` deterministic, ``/metrics`` with
    the fleet, gateway and MemWatch families); (b)
    ``MultiTenantReconciler`` over two bf16 tenants (adapter evictions
    before any chip action, reclaims only from the low tenant and never
    below its floor, a grant and a calm release, exactly once in both,
    exact K1 and K2 launches; ``fairshare_error`` printed);
19. int8 MoE serving: the moe_heavy drain in f32 on ``quantize_params``
    weights, dense dispatch, the teacher-forced check, K7b twice per
    layer and K7a 4 per layer + 1 for each such pass, over the same
    passes, every one on the CUDA-core route;
20. tensor, expert and pipeline parallelism (``phase_mesh_train``):
    worker processes sharing the card over gloo; f32 2-layer steps over
    tp=2 and ep=2 x tp=2 (MoE gmm, four ranks) against one CPU process,
    loss, gathered gradients and parameters; the 154M over tp=2 (8 of
    16 heads a rank) and over pp=2 (GPipe, 4 layers a stage, 4
    microbatches) and moe_heavy over ep=2 (8 experts and a dead group a
    rank), SP_STEPS steps each against the single-device losses, exact
    per-rank K1/K3/K4/K5/K6 launches on the tensor cores;
20a. the multichip certification (``phase_multichip``, the port's
    ``graft_entry.py``; in a process of its own, :class:`PhaseChild`,
    beside phase 20): (a) ``dryrun_multichip(8)``, eight rank
    processes sharing the card over gloo, three f32 steps of each of
    the JAX dryrun's configs on ep=2 x sp=2 x tp=2 (ring with capacity
    MoE and remat, Ulysses with GQA and dense MoE, dropless gmm) and of
    its pp=4 x dp=2 pipeline: every loss finite and decreasing, each
    run's first loss within MULTICHIP_LOSS_RTOL of one process's
    single-device f32 step of the same weights and batch, each rank's
    K1, K1-block, K3, K4, K5, K6 launches by route, the tp-sharded
    decode's tokens equal to ``greedy_generate``'s on every rank; (b)
    the 154M at full width served over ``MeshSpec(tp=2)`` by two ranks,
    in f32 and bf16, plain and in each of what tp decode once refused
    (MULTICHIP_VARIANTS: the int8 KV cache, ``quantize_params`` weights
    through K7, a paged pool of 16-token blocks read by K2, LoRA rows on
    slots 0-3 of three rank-8 adapters): 8 prompts of 96 tokens and 32
    greedy tokens through ``prefill`` + ``decode_step_rows`` (or
    ``paged_decode_step_rows``) against single-process
    ``greedy_generate`` (the plain run) or the same loop without a mesh
    on the card, f32 prefill and first-step logits within
    MULTICHIP_F32_TOL of their largest magnitude (the int8 cache's
    first step within MULTICHIP_INT8KV_STEP_TOL, its int8 k/v entries
    off the twin's printed) and every token equal, bf16 logits within twice the same variant's single-device
    bf16-to-f32 gap (tokens printed), each rank's K1, K2 and K7 launches
    by route exactly :func:`multichip_launches`', the wall a token; (c)
    ``graft_entry.entry()``'s forward on the card against the same
    forward on the CPU (plain path) at TOL[bf16] of the largest logit;
    (d) moe_heavy in f32 over ``MeshSpec(ep=2, tp=2)`` by four ranks
    of the same worker (started beside (b)'s): the same traffic's
    prefill and greedy steps against single-process ``greedy_generate``, logits within
    MULTICHIP_F32_TOL and every token equal, K1 4 a prefill a rank;
    (e) the engine variant, started beside (b) and (d): two ranks of
    the same worker serve the 154M at full width through
    ``ServingEngine(..., mesh=MeshSpec(tp=2))`` on their
    ``shard_params`` blocks, in f32 and bf16, and drain s8_r24
    (MULTICHIP_ENGINE_REQUESTS of its requests) in each of
    MULTICHIP_ENGINE_MODES (step by step, fused at ``chain_steps=47``,
    which runs step by step under a mesh, n-gram speculation, the
    paged pool read by K2) against the same engine without a mesh on
    the whole weights in this process: f32 streams every one equal
    (gated), bf16 streams counted, each rank's K1 and K2 launches by
    route exactly :func:`engine_launches`' of its dispatch labels, the
    drain's wall;
20b. the measurement utilities (``phase_measure``): (a) the
    autotuner names the card (``backend_key``), the checked-in H100
    table is empty so every K7 launch of the run took ``int8_plan``'s
    plan (picks by source printed, none measured), ``Autotuner.tune``
    times K7a at the 154M unembedding and K7b at moe_heavy's
    up-projection over a few ``k_chunk``/``ring`` plans with the
    differential-median harness (each plan valid only within INT8_TOL
    of its plain version), and the saved table, pointed to by
    ``TPU_AUTOTUNE_TABLE``, makes the wrappers launch the tuned plans
    within tolerance before the default is restored; (b) every probe of
    ``ops/collectives.py`` (attention forward and gradient, the matmul
    yardstick, decode on bf16 and int8 weights, serving at chain_steps
    1 and 47, dispatch, the one-card all-reduce) at its defaults,
    ``valid`` under the H100 ceilings, its K1, K3/K4 and K7 launches
    joining the kernels line; (c) a Chrome trace of one 154M generation
    step holding the ``annotate`` span and K1, a device memory
    snapshot, and the fleet simulator's probe (1000 replicas, seed 7,
    20 cycles, a 70-cycle A/B), which runs on the host in a process of
    its own from the end of the kernel checks (phases 3-6, 14) on: no
    violation, every cycle survived, the minimized repro starving, and
    a same-seed rerun of its soak with an equal journal digest;
21. each kernel's device time at its main-path shape and at a long
    context (torch.profiler), after the drains and the steps so that
    profiling cannot tax them;
22. one JSON line naming every kernel with its launches on the main
    paths (serving drains and training steps), its error against the
    plain version and its times; K1, K3-K6 name their tensor-core
    source and launches, and their f32 route's apart; K7 its launches
    by route.  A kernel or library reading below its bound is flagged
    impossible, re-timed cold and, if still below, not used;
23. last line: ``{"ok": true, "device": {...}}``.

Every drain and step holds its K1, K5, K6 and K7 launches to the route
of its dtype: bf16 on the tensor cores, f32 on the CUDA cores.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import atexit
import dataclasses
import gc
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

if __name__ == "__main__":
    # An interpreter whose site-packages hold no bytecode and whose
    # environment sets PYTHONDONTWRITEBYTECODE compiles torch from source
    # at every import (7-10 s on the H100 machine; about 6 s from
    # bytecode, PERF.md section 6).  This process writes the bytecode of
    # what it imports under build/pycache, and every child it starts
    # (pods, workers, pumps, daemons) reads it from there.
    PYCACHE = str(Path(__file__).resolve().parent / "build" / "pycache")
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = PYCACHE
    sys.pycache_prefix = PYCACHE
    sys.dont_write_bytecode = False

import numpy as np
import torch

# bf16 outputs are rounded to 8 mantissa bits (relative 2^-8, about
# 0.004 at |x| <= 1) and the kernel sums in another order than the
# plain version; f32 differs only by summation order and expf.
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
LSE_TOL = 1e-3
# bf16 K1 (tensor cores) against its rounding plain version
# flash_forward_reference, relative to max(1, max|plain|), on the output
# before its final rounding: the kernel forms q' and p with the plain
# version's operations, and the plain version sums its bf16 scores on
# the tensor cores in the kernel's order, so only the sums of l and of
# p.v part them (a few units in the last place); a bf16 step of one p
# would show as about 4e-3 of that p's row, and the version without the
# TPU kernel's roundings misses JAX's kernel by 6.9e-4 to 1.7e-3 of
# max(1, max|ref|) (tests/test_torch_flash_fwd.py's cases on the CPU).
# Held as well: the bf16 output is that f32 output rounded, bit for
# bit, and it stays within TOL[bf16] of the f32 oracle
# attention_forward.
FWD_TC_TOL = 1e-4
# teacher-forced check: each greedy token's logit in one full-sequence
# forward pass must be within this of that position's max.  bf16 decode
# (stepwise cache reads) and the full forward round differently; with
# random weights the top two logits are often ~0.2 apart.
TF_MARGIN = 0.1

# K3/K4 against their plain version, relative to the largest gradient
# entry (about 10 at the training shape): in f32 attention_block_grads,
# in bf16 flash_block_grads_reference, which rounds p and ds to bf16
# where the kernels (and the TPU kernels) do.  Both sum exact products
# of the same operands in f32 and differ in summation order over up to
# 2048 terms and in exp's last bits, which may round an entry of p or
# ds to the neighbouring bf16 value.
BWD_TOL = 1e-3
# bf16 K3/K4 against the f32 oracle attention_block_grads, which keeps
# p and ds in f32: JAX's own Pallas kernels, which round them, are about
# 2e-3 of max|ref| from it on the CPU (B=1 T=128 H=4 Hkv=2 D=64 causal
# bf16; 0.8-2.2e-3 in tests/test_torch_flash_bwd.py)
BWD_BF16_ORACLE_TOL = 1e-2
#: the small head dims the kernels take beside 64 and 128: the JAX
#: package's probe models (8, 16 and 32).  Phases 3-5 hold every kernel
#: at each of them in both dtypes; the reference-width probes run them
#: on the main paths
SMALL_DIMS = (8, 16, 32)
#: the kernels-line rows of the small head dims: each kernel at a shape
#: a reference-width probe gives it (filled by phases 3, 4 and 5)
SMALL_D_ROWS: dict = {}
#: the kernels line's rows of K2 and K7a at the shapes of one tp=2 rank
#: of the 154M (phase_multichip (b)): filled by phase_paged and
#: phase_int8, a list a kernel
TP_RANK_ROWS: dict = {"K1": [], "K2": [], "K7a": []}
# training, f32 card (kernels) vs CPU (plain): summation order only; a
# missing or wrong gradient moves a weight by a whole AdamW step (lr
# 3e-4), three times this bound
STEP_LOSS_RTOL = 1e-4
STEP_PARAM_ATOL = 1e-4
# resumed vs uninterrupted losses: the embedding gather's backward sums
# rows in an order that may change between runs (bf16 weights, one
# rounding step is 2^-8 relative), so three bf16 steps may part by a
# few thousandths at a loss near 10
RESUME_TOL = 2e-2
TRAIN_STEPS = 6
TRAIN_SAVE_AT = 3
TRAIN_B, TRAIN_T = 8, 2048

# K5 against gmm_reference, relative to max(1, max|plain|): both sum in
# f32 and differ in order only; in bf16 the two f32 sums may round to
# neighbouring bf16 values (2^-8 of the value, below 4e-3 of the max).
GMM_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
# K6 against gmm_dw_reference: f32 output from inputs that f32 holds
# exactly (bf16 products are exact in f32), so summation order over up
# to 16,384 rows is the only difference
DW_TOL = 1e-4
# moe_heavy training (gmm dispatch) at the JAX package's MoE batch
MOE_B, MOE_T = 8, 1024
MOE_AUX_WEIGHT = 0.01
# gmm against dense dispatch on one forward of the same weights in f32:
# the same expert products summed in another order (K5 against cuBLAS),
# held relative to max(1, max|dense|).  Not in bf16: there the router's
# bf16 logits tie at the k-th gate for about 1% of tokens, and the two
# dispatches of the JAX package itself part there (dense keeps every
# expert tied with the k-th gate, gmm's top-k exactly k), by whole
# logits; the bf16 gap and its tie count are printed, not held.
DISPATCH_TOL = 1e-3
# f32 steps card vs CPU: parameters whose gradient is nonzero but
# below this fraction of its tensor's largest entry are rounding noise
# for AdamW's first update (see step_param_errors)
NOISE_BAND = 1e-5

# K7 against its plain version, relative to max(1, max|plain|): both sum
# exact products of the same inputs in f32, in another order; a bf16
# output may round to the neighbouring bf16 value (2^-8 of the value)
INT8_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
# quantize_params against the full-precision weights on one forward, as
# the JAX package's test holds them (tests/test_quant.py)
QUANT_MEAN_REL = 0.05
QUANT_AGREE = 0.9

#: the device layer's card memory (the H100 80GB HBM3's nvidia-smi
#: memory.total) against torch's total_memory: at most it, at least
#: this share of it
DRIVER_HBM_SHARE = 0.95

H100_BYTES_PER_S = 3.35e12
H100_BF16_FLOPS = 989e12
H100_F32_FLOPS = 67e12


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


class ScriptClock:
    """The script's stretches on the host's clock: ``mark(name)`` prints
    the seconds since the last mark and since the start; ``summary()``
    the marks on one line, slowest first."""

    def __init__(self):
        self.t0 = self.last = time.perf_counter()
        self.marks = []

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.marks.append((name, round(now - self.last, 1)))
        print(f"script clock: {name} {now - self.last:.1f} s, "
              f"{now - self.t0:.1f} s since the start", flush=True)
        self.last = now

    def summary(self) -> str:
        return json.dumps({
            "total_s": round(time.perf_counter() - self.t0, 1),
            "stretches_s": dict(sorted(self.marks, key=lambda m: -m[1]))})


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time per call of ``fn()`` between CUDA events around
    ``iters`` back-to-back calls: device time, plus any gaps where the
    device waited for the host to enqueue the next call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 10) -> float | None:
    """Device time per call of ``fn()``: the summed time of every kernel
    it runs (torch.profiler over CUPTI), host gaps excluded.  None when
    the profiler reports no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(e, "self_device_time_total", 0.0)
                   for e in prof.key_averages())
    return total_us / iters / 1e3 if total_us > 0 else None


_flush: list = []


def flush_l2() -> None:
    """Overwrite a 64 MiB buffer, more than the card's 50 MB L2, so the
    next call reads its inputs from device memory."""
    if not _flush:
        _flush.append(torch.empty(64 << 20, dtype=torch.uint8,
                                  device="cuda"))
    _flush[0].zero_()


def cold_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean time of ``fn()`` between CUDA events around each call, with
    the L2 flushed before it: the case of a decode step, which streams
    more weights than L2 holds.  The card spins for about 0.5 ms after
    the flush, so the host has enqueued the call before the first event
    fires and the events time the device, not the host's launch."""
    start = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    end = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for _ in range(warmup):
        fn()
    for i in range(iters):
        flush_l2()
        torch.cuda._sleep(1_000_000)
        start[i].record()
        fn()
        end[i].record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in zip(start, end)) / iters


def cold_device_ms(fn, iters: int = 10) -> float | None:
    """Device time of ``fn()`` after an L2 flush: the profiled time of
    flush + call less that of the flush alone."""
    both = device_ms(lambda: (flush_l2(), fn()), iters)
    alone = device_ms(flush_l2, iters)
    return None if both is None or alone is None else both - alone


def trusted(label: str, what: str, ms: float | None, bound_ms: float,
            fn) -> float | None:
    """A reading of ``fn`` no faster than the card allows: ``ms`` when
    it is at least ``bound_ms``.  A faster one is impossible: it is
    flagged and ``fn`` re-timed cold (:func:`cold_device_ms`, L2
    flushed); the re-timing is returned when it is at least the bound,
    else None, so a flagged reading is never used as a yardstick."""
    if ms is None or ms >= bound_ms:
        return ms
    cold = None if fn is None else cold_device_ms(fn)
    ok = cold is not None and cold >= bound_ms
    print(f"{label}: {what} {ms:.4f} ms is below the bound "
          f"{bound_ms:.4f} ms: impossible; cold re-time {fmt(cold)} ms"
          f"{'' if ok else ', still impossible: not used'}", flush=True)
    return cold if ok else None


def fmt(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def phase_device() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a "
             "CUDA card")
    print(card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)
    return torch.cuda.get_device_name(0)


def ptxas_lines(log: str) -> list[str]:
    """One line per compiled kernel from the ``-Xptxas -v`` log: its
    source, its mangled name, registers, spill bytes and static shared
    memory."""
    out, src, name = [], "", ""
    for line in log.splitlines():
        if line.startswith("== "):
            src = line[3:].split(" ")[0]
        elif "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line and name:
            out.append(f"ptxas {src} {name}: {spills}; "
                       f"{line.split(':', 1)[1].strip()}")
            name = ""
    return out


def phase_build(build) -> None:
    t0 = time.perf_counter()
    build.library()
    took = time.perf_counter() - t0
    print(f"build: {took:.2f} s (nvcc: {build.build_seconds}) log "
          f"{build.build_log}", flush=True)
    print("\n".join(ptxas_lines(build.build_log.read_text())), flush=True)


def smi_cards() -> tuple[list[dict], list[int]]:
    """The cards as ``nvidia-smi`` lists them (index, uuid, bus id,
    name, memory MiB), and the minor numbers of ``nvidia-smi -q``."""
    query = subprocess.run(
        ["nvidia-smi", "--query-gpu=index,uuid,pci.bus_id,name,"
         "memory.total", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60)
    full = subprocess.run(["nvidia-smi", "-q"], capture_output=True,
                          text=True, timeout=60)
    if query.returncode or full.returncode:
        fail(f"nvidia-smi failed: {query.stderr}{full.stderr}")
    cards = []
    for line in query.stdout.strip().splitlines():
        index, uuid, bus, name, mem = (f.strip() for f in line.split(","))
        cards.append(dict(index=int(index), uuid=uuid, bus=bus, name=name,
                          mib=int(mem)))
    minors = [int(line.split(":")[1]) for line in full.stdout.splitlines()
              if line.strip().startswith("Minor Number")]
    return cards, minors


def driver_child(want: str) -> None:
    """phase_driver (d), in a child under CUDA_VISIBLE_DEVICES=<want>:
    one card, whose UUID is ``want``, and K1 against its plain version
    at phase 3's tolerance; one JSON line, exit 1 on any failure."""
    from k8s_dra_driver_tpu_torch.ops import flash_attention as fa
    n = torch.cuda.device_count()
    uuid = "GPU-" + str(torch.cuda.get_device_properties(0).uuid)
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn((2, 96, h, 64), generator=gen, device="cuda")
               .to(torch.bfloat16) for h in (16, 4, 4))
    before = fa.tc_launches
    out, lse = fa.flash_forward(q, k, v, causal=True)
    full, full_lse = fa.flash_forward(q, k, v, causal=True,
                                      out_dtype=torch.float32)
    ref, ref_lse = fa.flash_forward_reference(q, k, v, causal=True,
                                              out_dtype=torch.float32)
    oracle = fa.attention_forward(q, k, v, causal=True)[0]
    torch.cuda.synchronize()
    scale = max(1.0, ref.abs().max().item())
    row = dict(count=n, uuid=uuid, name=torch.cuda.get_device_name(0),
               launches=fa.tc_launches - before,
               err=(full - ref).abs().max().item(),
               rounded=bool(torch.equal(out, full.to(torch.bfloat16))
                            and torch.equal(lse, full_lse)),
               oracle_err=(out.float() - oracle.float()).abs().max().item(),
               lse_err=(lse - ref_lse).abs().max().item())
    row["ok"] = (n == 1 and uuid == want and row["launches"] == 2
                 and row["err"] <= FWD_TC_TOL * scale and row["rounded"]
                 and row["oracle_err"] <= TOL[torch.bfloat16]
                 and row["lse_err"] <= LSE_TOL)
    print(json.dumps(row), flush=True)
    sys.exit(0 if row["ok"] else 1)


def phase_driver() -> None:
    """The driver's device layer against the live card: enumeration,
    the device model, both allocator engines, and a child process on
    the allocated card (see the module docstring, 2b)."""
    from k8s_dra_driver_tpu_torch.allocator import AllocationError, Allocator
    from k8s_dra_driver_tpu_torch.allocator import native as native_alloc
    from k8s_dra_driver_tpu_torch.api import resource
    from k8s_dra_driver_tpu_torch.api.classes import standard_device_classes
    from k8s_dra_driver_tpu_torch.cluster import Node
    from k8s_dra_driver_tpu_torch.devicemodel import enumerate_host_devices
    from k8s_dra_driver_tpu_torch.discovery import GENERATIONS, SysfsBackend
    from k8s_dra_driver_tpu_torch.discovery.native import (NativeBackend,
                                                           ensure_built)
    from k8s_dra_driver_tpu_torch.discovery.probe import probe, tools
    from k8s_dra_driver_tpu_torch.discovery.sysfs import (
        normalize_bus_id, nvidia_product_name)
    t0 = time.perf_counter()
    card = card_line()
    root = Path(__file__).resolve().parent
    shims = [str(p.relative_to(root)) for p in (ensure_built(),
                                                native_alloc.ensure_built())]
    native_alloc.load()
    shim_s = time.perf_counter() - t0

    def line(part: str, text: str) -> None:
        print(f"driver ({part}) [{card}, {time.perf_counter() - t0:.2f} s "
              f"into the phase]: {text}", flush=True)

    # (a) enumeration: the two backends, nvidia-smi and torch.cuda
    py = SysfsBackend("/").enumerate()
    cc = NativeBackend("/").enumerate()
    if dataclasses.asdict(py) != dataclasses.asdict(cc):
        fail(f"driver (a): the backends disagree: python {py}, "
             f"shim {cc}")
    smi, minors = smi_cards()
    n = torch.cuda.device_count()
    cuda = {}
    for i in range(n):
        props = torch.cuda.get_device_properties(i)
        cuda["GPU-" + str(props.uuid)] = dict(
            bus=f"{props.pci_domain_id:04x}:{props.pci_bus_id:02x}:"
                f"{props.pci_device_id:02x}.0", name=props.name,
            total=props.total_memory)
    chips = {c.uuid: c for c in py.chips}
    if not len(chips) == len(smi) == n or set(chips) != set(cuda):
        fail(f"driver (a): {len(chips)} cards enumerated {sorted(chips)}, "
             f"nvidia-smi {len(smi)}, torch.cuda {n} {sorted(cuda)}")
    if sorted(minors) != sorted(c.index for c in py.chips):
        fail(f"driver (a): indices {[c.index for c in py.chips]} are not "
             f"nvidia-smi's minor numbers {minors}")
    smi_buses = {normalize_bus_id(c["bus"]) for c in smi
                 if c["bus"] not in ("[N/A]", "N/A")}
    if {c["uuid"] for c in smi} != set(chips) or not smi_buses <= {
            c.pci_address for c in py.chips}:
        fail(f"driver (a): nvidia-smi's UUIDs {[c['uuid'] for c in smi]} "
             f"/ bus ids {smi_buses} are not the enumerated ones")
    h100 = GENERATIONS["h100"]
    for uuid, c in chips.items():
        want = cuda[uuid]
        if (c.pci_address != want["bus"] or c.generation != h100
                or nvidia_product_name(want["name"]) != h100.product_name):
            fail(f"driver (a): {c} against torch.cuda's {want}")
        for path in c.dev_paths:
            if not os.path.exists(path):
                fail(f"driver (a): {path} of {uuid} does not exist")
    if any(nvidia_product_name(c["name"]) != h100.product_name
           or c["mib"] * 2**20 != h100.hbm_bytes_per_chip for c in smi):
        fail(f"driver (a): nvidia-smi's cards {smi} are not the h100 entry")
    expected = {c.index for c in py.chips}
    for backend in (SysfsBackend("/"), NativeBackend("/")):
        bad = backend.health(expected=expected)
        if bad:
            fail(f"driver (a): unhealthy cards {bad}")
    line("a", f"shims {shims} built or found and loaded in {shim_s:.2f} s; "
         f"{n} card(s) equal from the Python backend and the shim: "
         + "; ".join(f"index {c.index} {c.uuid} {c.pci_address} "
                     f"{c.dev_paths[0]} {c.generation.name}"
                     for c in py.chips)
         + f"; libcuda {py.libtpu_path}; nvidia-smi: {smi} (UUIDs equal "
         f"to the enumerated ones, bus ids {sorted(smi_buses)} among "
         f"them), minors {minors}; torch.cuda: {cuda}; health {{}}")
    line("a", f"what the host shows: {json.dumps(probe('/'))}; tools "
         f"{json.dumps(tools())}")

    # (b) the device model
    devices = enumerate_host_devices(py)
    kinds = [d.kind for d in devices.values()]
    if (kinds.count("chip"), kinds.count("core")) != (n, n) or (
            n == 1 and "slice" in kinds):
        fail(f"driver (b): devices {sorted(devices)}")
    for name, dev in devices.items():
        if dev.kind != "chip":
            continue
        d = dev.to_device()
        total = cuda[d.attributes["uuid"]]["total"]
        hbm = d.capacity["hbm"]
        if not DRIVER_HBM_SHARE * hbm <= total <= hbm:
            fail(f"driver (b): {name} hbm {hbm} against total_memory "
                 f"{total}")
        line("b", f"{name}: uuid {d.attributes['uuid']} (CUDA's), "
             f"productName {d.attributes['productName']}, hbm {hbm} B "
             f"(81559 MiB); total_memory {total} B = "
             f"{total / hbm:.4f} of it (>= {DRIVER_HBM_SHARE}); devices "
             f"{sorted(devices)}")

    # (c) allocation by both engines
    pool = py.hostname
    rslice = resource.ResourceSlice(
        metadata=resource.ObjectMeta(name=f"{pool}-slice"),
        driver="tpu.google.com", pool=resource.ResourcePool(name=pool),
        node_name=pool, devices=[d.to_device() for _, d in
                                 sorted(devices.items())])
    nodes = [Node(metadata=resource.ObjectMeta(name=pool))]
    classes = standard_device_classes()

    def claim(name, cls, cel):
        return resource.ResourceClaim(
            metadata=resource.ObjectMeta(name=name, namespace="default"),
            spec=resource.ResourceClaimSpec(devices=resource.DeviceClaim(
                requests=[resource.DeviceRequest(
                    name="r0", device_class_name=cls,
                    selectors=[resource.DeviceSelector(cel=cel)])])))
    picked, refusals, ms = [], [], {}
    for engine in ("python", "native"):
        alloc = Allocator(engine=engine)
        first = claim("card", "tpu.google.com",
                      f'device.attributes["productName"] == '
                      f'"{h100.product_name}"')
        a0 = time.perf_counter()
        first.status.allocation = alloc.allocate(first, [rslice], classes,
                                                 nodes=nodes)
        ms[engine] = (time.perf_counter() - a0) * 1e3
        (res,) = first.status.allocation.results
        picked.append(res.device)
        index = devices[res.device].chips[0].index
        core = claim("core", "tpu-core.google.com",
                     f'device.attributes["index"] == {index}')
        try:
            alloc.allocate(core, [rslice], classes, nodes=nodes,
                           allocated_claims=[first])
            fail(f"driver (c): the {engine} engine gave the core of "
                 f"{res.device} to a second claim")
        except AllocationError as e:
            refusals.append(str(e))
    if picked[0] != picked[1] or refusals[0] != refusals[1]:
        fail(f"driver (c): engines disagree: {picked} {refusals}")
    uuid = devices[picked[0]].to_device().attributes["uuid"]
    line("c", f"python and native engines both allocate {picked[0]} "
         f"({uuid}) in {ms['python']:.3f} / {ms['native']:.3f} ms host; "
         f"its core refused by both: {refusals[0]}")

    # (d) the allocated card runs K1 in a child process
    env = dict(os.environ, CUDA_VISIBLE_DEVICES=uuid,
               PYTHONPATH=os.pathsep.join(
                   [str(root)] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    child = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "chip_smoke.driver_child(sys.argv[1])", uuid], cwd=root, env=env,
        capture_output=True, text=True, timeout=120)
    if child.returncode:
        fail(f"driver (d): the child on {uuid} exited {child.returncode}: "
             f"{child.stdout[-2000:]}{child.stderr[-4000:]}")
    row = json.loads(child.stdout.strip().splitlines()[-1])
    line("d", f"child under CUDA_VISIBLE_DEVICES={uuid}: {row['count']} "
         f"device, {row['name']} {row['uuid']}; K1 B=2 T=96 H=16 Hkv=4 "
         f"D=64 causal bf16, {row['launches']} launches: f32 output "
         f"max|d|={row['err']:.3g} (tol {FWD_TC_TOL} x max(1, max|plain|)),"
         f" bf16 the f32 rounded: {row['rounded']}, oracle "
         f"max|d|={row['oracle_err']:.3g} (tol {TOL[torch.bfloat16]}), lse "
         f"max|d|={row['lse_err']:.3g} (tol {LSE_TOL}); phase wall "
         f"{time.perf_counter() - t0:.2f} s")


PLUGIN_NODE = "h100-node"
PLUGIN_READY_S = 60.0


def plugin_thread(plugin_cmd, argv: list[str], client):
    """The port's ``cmd/plugin.py`` ``run`` on a thread, as the binary
    runs it; returns (thread, stop event) once it is ready."""
    args = plugin_cmd.build_parser().parse_args(argv)
    ready, stop = threading.Event(), threading.Event()
    t = threading.Thread(target=plugin_cmd.run, args=(args,),
                         kwargs=dict(client=client, ready_event=ready,
                                     stop_event=stop),
                         name="tpu-dra-plugin", daemon=True)
    t.start()
    if not ready.wait(PLUGIN_READY_S):
        stop.set()
        fail(f"plugin: not ready within {PLUGIN_READY_S} s")
    return t, stop


def plugin_stop(t, stop) -> None:
    stop.set()
    t.join(timeout=30)
    if t.is_alive():
        fail("plugin: run() did not return within 30 s of its stop")


def cdi_apply(cdi_root: Path, cdi_ids: list[str]) -> dict:
    """A small CDI interpreter, as a container runtime applies a claim's
    qualified device ids: each id's spec file by kind and device by
    name; the spec's common edits, then the device's.  Env entries merge
    last-wins; device nodes and mounts accumulate once each."""
    specs = [json.loads(p.read_text()) for p in sorted(
        cdi_root.glob("*.json"))]
    env, nodes, mounts = {}, [], []
    for qualified in cdi_ids:
        kind, _, name = qualified.partition("=")
        hits = [(s, d) for s in specs if s["kind"] == kind
                for d in s["devices"] if d["name"] == name]
        if len(hits) != 1:
            fail(f"plugin: CDI id {qualified} resolves to {len(hits)} "
                 f"device(s)")
        spec, dev = hits[0]
        for edits in (spec.get("containerEdits", {}),
                      dev.get("containerEdits", {})):
            for e in edits.get("env", []):
                k, _, v = e.partition("=")
                env[k] = v
            for n in edits.get("deviceNodes", []):
                if n["path"] not in nodes:
                    nodes.append(n["path"])
            for m in edits.get("mounts", []):
                if m not in mounts:
                    mounts.append(m)
    return dict(env=env, device_nodes=nodes, mounts=mounts)


def phase_plugin() -> dict:
    """The port's kubelet plugin on the live card (see the module
    docstring, 2c).  Returns the gRPC latencies and the child's K1
    reading."""
    import logging

    import grpc

    from k8s_dra_driver_tpu_torch.allocator import Allocator
    from k8s_dra_driver_tpu_torch.api import resource
    from k8s_dra_driver_tpu_torch.api.classes import standard_device_classes
    from k8s_dra_driver_tpu_torch.cluster import FakeCluster, Node
    from k8s_dra_driver_tpu_torch.cmd import plugin as plugin_cmd
    from k8s_dra_driver_tpu_torch.discovery import GENERATIONS
    from k8s_dra_driver_tpu_torch.discovery.sysfs import nvidia_product_name
    from k8s_dra_driver_tpu_torch.plugin import (DeviceState,
                                                 DeviceStateConfig, Driver)
    from k8s_dra_driver_tpu_torch.plugin import cdi as cdi_mod
    from k8s_dra_driver_tpu_torch.plugin.cdi_schema import validate_spec
    from k8s_dra_driver_tpu_torch.plugin.health import HealthMonitor
    from k8s_dra_driver_tpu_torch.proto import (DRAPluginStub,
                                                RegistrationStub, dra_pb2,
                                                registration_pb2)
    t0 = time.perf_counter()
    card = card_line()
    root = Path(__file__).resolve().parent
    tmp = Path(tempfile.mkdtemp(prefix="cps-", dir="/tmp"))
    saved_log = (logging.getLogger().handlers[:],
                 logging.getLogger().level)
    argv = ["--node-name", PLUGIN_NODE, "--plugin-root",
            str(tmp / "plugin"), "--registrar-root", str(tmp / "reg"),
            "--cdi-root", str(tmp / "cdi"), "--fake-cluster",
            "--discovery", "auto", "--health-interval", "0", "-v", "0"]
    cdi_root, plugin_root = tmp / "cdi", tmp / "plugin"
    h100 = GENERATIONS["h100"]
    cuda = {}
    for i in range(torch.cuda.device_count()):
        props = torch.cuda.get_device_properties(i)
        cuda["GPU-" + str(props.uuid)] = nvidia_product_name(props.name)
    out = {}

    def line(part: str, text: str) -> None:
        print(f"plugin ({part}) [{card}, {time.perf_counter() - t0:.2f} s "
              f"into the phase]: {text}", flush=True)

    client = FakeCluster()
    client.create(Node(metadata=resource.ObjectMeta(name=PLUGIN_NODE)))
    classes = standard_device_classes()
    for cls in classes.values():
        client.create(cls)
    try:
        # (a) boot: live discovery, publication, registration, the spec
        t, stop = plugin_thread(plugin_cmd, argv, client)
        boot_s = time.perf_counter() - t0
        (rslice,) = client.list("ResourceSlice")
        devs = {d.name: d for d in rslice.devices}
        chips = {d.attributes["uuid"]: d for d in devs.values()
                 if d.attributes.get("type") == "chip"}
        cores = [d for d in devs.values()
                 if d.attributes.get("type") == "core"]
        if set(chips) != set(cuda) or len(cores) != len(cuda) or (
                len(cuda) == 1 and len(devs) != 2):
            fail(f"plugin (a): published {sorted(devs)} with chip UUIDs "
                 f"{sorted(chips)}; torch.cuda has {sorted(cuda)}")
        for uuid, d in chips.items():
            if (d.attributes["productName"] != cuda[uuid]
                    or cuda[uuid] != h100.product_name):
                fail(f"plugin (a): {d.name} productName "
                     f"{d.attributes['productName']} against CUDA's "
                     f"{cuda[uuid]}")
        reg = RegistrationStub(grpc.insecure_channel(
            f"unix://{tmp / 'reg' / 'tpu.google.com-reg.sock'}"))
        info = reg.GetInfo(registration_pb2.InfoRequest(), timeout=10)
        sock = plugin_root / "plugin.sock"
        if (info.name, info.type, info.endpoint) != (
                "tpu.google.com", "DRAPlugin", str(sock)):
            fail(f"plugin (a): GetInfo answered {info}")
        std = json.loads((cdi_root / "tpu.google.com-chip.json")
                         .read_text())
        validate_spec(std)
        common = std["containerEdits"]
        nodes = [n["path"] for d in std["devices"]
                 for n in d["containerEdits"].get("deviceNodes", [])]
        nodes += [n["path"] for n in common.get("deviceNodes", [])]
        hosts = [m["hostPath"] for m in common.get("mounts", [])]
        missing = [p for p in nodes + hosts if not os.path.exists(p)]
        if missing or "NVIDIA_VISIBLE_DEVICES=void" not in common.get(
                "env", []) or cdi_mod.CONTAINER_LIBCUDA_PATH not in [
                m["containerPath"] for m in common.get("mounts", [])]:
            fail(f"plugin (a): standard spec {json.dumps(std)}; missing on "
                 f"the host: {missing}")
        line("a", f"run() ready in {boot_s:.2f} s (--discovery auto); "
             f"ResourceSlice {rslice.metadata.name} pool "
             f"{rslice.pool.name} devices {sorted(devs)}: "
             + "; ".join(f"{d.name} uuid {u} productName "
                         f"{d.attributes['productName']}"
                         for u, d in sorted(chips.items()))
             + f"; GetInfo {info.name} {info.type} {info.endpoint} "
             f"{list(info.supported_versions)}; standard spec valid, "
             f"device nodes {nodes} and mounts {hosts} all present, env "
             f"{common.get('env')}")

        # (b) prepare a claim the allocator gave the card, run K1 under it
        def allocated(name, configs=()):
            c = resource.ResourceClaim(
                metadata=resource.ObjectMeta(name=name, namespace="default",
                                             uid=f"uid-{name}"),
                spec=resource.ResourceClaimSpec(
                    devices=resource.DeviceClaim(
                        requests=[resource.DeviceRequest(
                            name="r0", device_class_name="tpu.google.com",
                            selectors=[resource.DeviceSelector(
                                cel=f'device.attributes["productName"] == '
                                    f'"{h100.product_name}"')])],
                        config=[resource.ClaimConfig(
                            opaque=resource.OpaqueConfig(
                                driver="tpu.google.com", parameters=p))
                            for p in configs])))
            c.status.allocation = Allocator().allocate(
                c, client.list("ResourceSlice"), classes,
                nodes=client.list("Node"))
            client.create(c)
            return c

        stub = DRAPluginStub(grpc.insecure_channel(f"unix://{sock}"))

        def grpc_call(verb, claim):
            req_cls = (dra_pb2.NodePrepareResourcesRequest if verb ==
                       "prepare" else dra_pb2.NodeUnprepareResourcesRequest)
            fn = (stub.NodePrepareResources if verb == "prepare"
                  else stub.NodeUnprepareResources)
            c0 = time.perf_counter()
            resp = fn(req_cls(claims=[dra_pb2.Claim(
                uid=claim.metadata.uid, namespace="default",
                name=claim.metadata.name)]), timeout=30)
            ms = (time.perf_counter() - c0) * 1e3
            res = resp.claims[claim.metadata.uid]
            if res.error:
                fail(f"plugin: {verb} of {claim.metadata.name}: "
                     f"{res.error}")
            return res, ms

        claim = allocated("card")
        (pick,) = claim.status.allocation.results
        uuid = devs[pick.device].attributes["uuid"]
        res, prep_ms = grpc_call("prepare", claim)
        ids = [i for d in res.devices for i in d.cdi_device_ids]
        spec_path = cdi_root / f"tpu.google.com-claim_{claim.metadata.uid}.json"
        cspec = json.loads(spec_path.read_text())
        validate_spec(cspec)
        if cspec["devices"][0]["containerEdits"].get("env") != [
                f"CUDA_VISIBLE_DEVICES={uuid}"]:
            fail(f"plugin (b): claim spec {json.dumps(cspec)}")
        view = cdi_apply(cdi_root, ids)
        gone = [p for p in view["device_nodes"] + [
            m["hostPath"] for m in view["mounts"]] if not os.path.exists(p)]
        if gone or view["env"].get("CUDA_VISIBLE_DEVICES") != uuid:
            fail(f"plugin (b): the container's edits {view}; missing {gone}")
        env = dict(os.environ, **view["env"], PYTHONPATH=os.pathsep.join(
            [str(root)] + [p for p in os.environ.get(
                "PYTHONPATH", "").split(os.pathsep) if p]))
        child = subprocess.run(
            [sys.executable, "-c", "import sys, chip_smoke; "
             "chip_smoke.driver_child(sys.argv[1])", uuid], cwd=root,
            env=env, capture_output=True, text=True, timeout=120)
        if child.returncode:
            fail(f"plugin (b): the child under the claim's edits exited "
                 f"{child.returncode}: {child.stdout[-2000:]}"
                 f"{child.stderr[-4000:]}")
        row = json.loads(child.stdout.strip().splitlines()[-1])
        out.update(prepare_ms=prep_ms, child=row)
        line("b", f"claim {claim.metadata.name} allocated {pick.device} "
             f"({uuid}); NodePrepareResources over gRPC {prep_ms:.3f} ms "
             f"host, CDI ids {ids}; the container's edits: env "
             f"{view['env']}, device nodes {view['device_nodes']}, mounts "
             f"{[(m['hostPath'], m['containerPath']) for m in view['mounts']]}"
             f" (a host process cannot bind-mount: sources checked "
             f"present); child: {row['count']} device, {row['name']} "
             f"{row['uuid']}; K1 B=2 T=96 H=16 Hkv=4 D=64 causal bf16, "
             f"{row['launches']} launches: f32 output max|d|="
             f"{row['err']:.3g} (tol {FWD_TC_TOL} x max(1, max|plain|)), "
             f"bf16 the f32 rounded: {row['rounded']}, oracle max|d|="
             f"{row['oracle_err']:.3g} (tol {TOL[torch.bfloat16]}), lse "
             f"max|d|={row['lse_err']:.3g} (tol {LSE_TOL})")

        # (c) restart over the same plugin root: the checkpoint keeps it
        plugin_stop(t, stop)
        spec_stat = spec_path.stat().st_mtime_ns, spec_path.read_text()
        r0 = time.perf_counter()
        t, stop = plugin_thread(plugin_cmd, argv, client)
        restart_s = time.perf_counter() - r0
        ckpt = json.loads((plugin_root / "checkpoint.json").read_text())
        if list(ckpt["v1"]["preparedClaims"]) != [claim.metadata.uid]:
            fail(f"plugin (c): checkpoint after restart {ckpt}")
        res2, again_ms = grpc_call("prepare", claim)
        ids2 = [i for d in res2.devices for i in d.cdi_device_ids]
        if ids2 != ids or (spec_path.stat().st_mtime_ns,
                           spec_path.read_text()) != spec_stat:
            fail(f"plugin (c): re-prepare gave {ids2} (first {ids}) or "
                 f"rewrote the claim spec")
        _, unprep_ms = grpc_call("unprepare", claim)
        ckpt = json.loads((plugin_root / "checkpoint.json").read_text())
        if spec_path.exists() or ckpt["v1"]["preparedClaims"]:
            fail(f"plugin (c): after unprepare the spec exists "
                 f"{spec_path.exists()}, checkpoint {ckpt}")
        out.update(unprepare_ms=unprep_ms, reprepare_ms=again_ms)
        line("c", f"restarted in {restart_s:.2f} s; the checkpoint holds "
             f"{claim.metadata.uid}; re-prepare {again_ms:.3f} ms gives "
             f"the same CDI ids and no spec write; NodeUnprepareResources "
             f"{unprep_ms:.3f} ms removed the claim spec and emptied the "
             f"checkpoint")

        # (d) a time-sliced claim on the card
        client.delete("ResourceClaim", "default", "card")
        ts = allocated("ts", [{
            "apiVersion": "tpu.google.com/v1alpha1",
            "kind": "TpuChipConfig",
            "sharing": {"strategy": "TimeSlicing",
                        "timeSlicing": {"interval": "Short"}}}])
        (tpick,) = ts.status.allocation.results
        minor = int(tpick.device.removeprefix("chip-"))
        _, ts_ms = grpc_call("prepare", ts)
        policy = plugin_root / "policy" / f"chip{minor}.json"
        tspec = json.loads((cdi_root / "tpu.google.com-claim_uid-ts.json")
                           .read_text())
        validate_spec(tspec)
        edits = tspec["devices"][0]["containerEdits"]
        want_env = [f"CUDA_VISIBLE_DEVICES={uuid}",
                    "TPU_RUNTIME_PREEMPTION_MS=1",
                    "TPU_TIMESHARE_DIR=/var/run/tpu-timeshare"]
        if (json.loads(policy.read_text()) != {"preemptionMs": 1}
                or edits.get("env") != want_env
                or [(m["hostPath"], m["containerPath"]) for m in
                    edits.get("mounts", [])] != [
                    (str(plugin_root / "timeshare"),
                     "/var/run/tpu-timeshare")]):
            fail(f"plugin (d): policy {policy.read_text()}, edits {edits}")
        _, ts_un_ms = grpc_call("unprepare", ts)
        if policy.exists():
            fail("plugin (d): unprepare left the time-slicing policy")
        line("d", f"time-sliced claim on {tpick.device}: policy "
             f"{policy.name} preemptionMs 1, claim env {edits['env']}, "
             f"timeshare mount; prepare {ts_ms:.3f} ms, unprepare "
             f"{ts_un_ms:.3f} ms reset the policy")
        plugin_stop(t, stop)

        # (e) health on the live backend, then a reported failure
        args = plugin_cmd.build_parser().parse_args(argv)
        backend = plugin_cmd.build_backend(args)
        hcluster = FakeCluster()
        state = DeviceState(backend, hcluster, DeviceStateConfig(
            plugin_root=str(tmp / "plugin-e"), cdi_root=str(tmp / "cdi-e"),
            node_name=PLUGIN_NODE))
        driver = Driver(state, hcluster, plugin_dir=str(tmp / "pe"))
        driver.start()
        try:
            if HealthMonitor(driver, backend, interval=0).check_once() or \
                    state.unhealthy:
                fail(f"plugin (e): the live card reads unhealthy "
                     f"{state.unhealthy}")

            class Reported:
                """The live backend, with the card reported failed
                while ``failed`` holds."""
                failed = True

                def health(self, expected=None):
                    live = backend.health(expected=expected)
                    if self.failed:
                        live = {**live, minor: "reported failed"}
                    return live

            def published():
                return sorted(d.name for s in hcluster.list("ResourceSlice")
                              for d in s.devices)
            before = published()
            seen = []
            wrapper = Reported()
            monitor = HealthMonitor(driver, wrapper, interval=0)
            monitor.listeners.append(seen.append)
            down = monitor.check_once()
            while_down = published()
            wrapper.failed = False
            up = monitor.check_once()
            after = published()
            if not (down and up and not any(
                    n.startswith(f"chip-{minor}") for n in while_down)
                    and after == before
                    and seen == [{minor: "reported failed"}, {}]):
                fail(f"plugin (e): down {down} up {up}; published "
                     f"{before} -> {while_down} -> {after}; listeners "
                     f"{seen}")
        finally:
            driver.shutdown()
        line("e", f"live check_once: no change, unhealthy {{}}; card "
             f"{minor} reported failed: republished {while_down}, "
             f"listeners {seen[0]}; healthy again: republished {after}")
    finally:
        root_log = logging.getLogger()
        root_log.handlers[:] = saved_log[0]
        root_log.setLevel(saved_log[1])
        shutil.rmtree(tmp, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t0
    print(f"plugin [{card}]: phase wall {out['wall_s']:.2f} s; gRPC "
          f"prepare {out['prepare_ms']:.3f} ms, re-prepare after restart "
          f"{out['reprepare_ms']:.3f} ms, unprepare "
          f"{out['unprepare_ms']:.3f} ms (host clock, one claim each); "
          f"child K1 max|d| {out['child']['err']:.3g}", flush=True)
    return out


COORD_NODE = "h100-coord"
#: the node's time-slicing policy for the card while (b) runs (the
#: file the plugin's TimeSlicingManager writes): the coordinator takes
#: the larger of the claim's quantum (0) and the node's as its cycle,
#: so two gated workers get windows of 500 ms each
COORD_POLICY_MS = 1000
#: K1 launches in one synchronized, stamped batch of a K1 child
COORD_BATCH = 100
#: wall seconds of each K1 child's stamped loop: (b) gated, (d) sliced
COORD_LOOP_S = 5.0
TS_LOOP_S = 3.0
#: the gate's longest sleep between two looks at the schedule
#: (coordclient/gate.py _run_coordinated)
GATE_REEVAL_S = 0.25
#: (c): the claim's device-memory limit on the card
COORD_HBM = "4Gi"
COORD_HBM_BYTES = 4 << 30
#: (e): greedy requests of s8_r24's prompts, new tokens each
LEASE_REQS = 4
LEASE_NEW = 16
DAEMON_MODULE = "k8s_dra_driver_tpu_torch.cmd.coordinatord"
GATE_MODULE = "k8s_dra_driver_tpu_torch.coordclient.gate"
#: the coordinator template's command, the reference's console script
COORD_COMMAND = ["tpu-coordinatord"]
CHILD_S = 180.0


def coord_k1_batches(out: str, seconds: float) -> None:
    """phase_coordination (b), (d), in a child under a claim's edits and
    the port's gate: K1 at phase 3's main-path shape (B=2 T=96 H=16
    Hkv=4 D=64 causal bf16) held to its plain version (those launches
    not counted), then batches of COORD_BATCH launches, each
    synchronized and stamped on the host clock (unix seconds), for
    ``seconds`` of wall time, stopped time included.  Writes its pid to
    ``out``.pid at the start and one JSON object to ``out`` at the
    end."""
    Path(out + ".pid").write_text(str(os.getpid()))
    from k8s_dra_driver_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn((2, 96, h, 64), generator=gen, device="cuda")
               .to(torch.bfloat16) for h in (16, 4, 4))
    full, _ = fa.flash_forward(q, k, v, causal=True,
                               out_dtype=torch.float32)
    ref, _ = fa.flash_forward_reference(q, k, v, causal=True,
                                        out_dtype=torch.float32)
    torch.cuda.synchronize()
    row = dict(pid=os.getpid(), count=torch.cuda.device_count(),
               uuid="GPU-" + str(torch.cuda.get_device_properties(0).uuid),
               err=(full - ref).abs().max().item(),
               tol=FWD_TC_TOL * max(1.0, ref.abs().max().item()))
    before, before_tc = fa.launches, fa.tc_launches
    batches = []
    end = time.time() + seconds
    while time.time() < end:
        t0 = time.time()
        for _ in range(COORD_BATCH):
            fa.flash_forward(q, k, v, causal=True)
        torch.cuda.synchronize()
        batches.append((t0, time.time()))
    row.update(launches=fa.launches - before,
               tc_launches=fa.tc_launches - before_tc, batches=batches)
    Path(out).write_text(json.dumps(row))


def coord_holder(go: str) -> None:
    """phase_coordination (b)'s ungated holder: once ``go`` exists it
    opens the card (a CUDA context), prints ``open`` and sleeps until
    it is killed."""
    while not os.path.exists(go):
        time.sleep(0.05)
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    print("open", flush=True)
    time.sleep(CHILD_S)


#: (c)'s child: the budget reaches the CUDA allocator before torch
#: starts (the coordclient package imports no torch)
HBM_CHILD = """
import sys
from k8s_dra_driver_tpu_torch.coordclient import CoordinatorClient
client = CoordinatorClient.from_env(name="hbm")
client.wait_ready(30)
client.register()
edits = client.apply_hbm_env(int(sys.argv[2]))
import chip_smoke
chip_smoke.coord_hbm_worker(client, edits, sys.argv[1])
"""


def await_status(cdir: Path, after: float, want, timeout_s: float = 15.0
                 ) -> dict:
    """The coordinator's status.json once it was written after
    ``after`` (unix seconds) and ``want(status)`` holds; the last one
    read on timeout."""
    deadline = time.time() + timeout_s
    status = {}
    while time.time() < deadline:
        try:
            status = json.loads((cdir / "status.json").read_text())
        except (OSError, ValueError):
            status = {}
        if status.get("updatedAt", 0) > after and want(status):
            return status
        time.sleep(0.05)
    return status


def coord_hbm_worker(client, edits: dict, out: str) -> None:
    """phase_coordination (c), in a child whose allocator option came
    from its claim's budget (``HBM_CHILD``): half the budget allocates,
    one and a half raise ``torch.cuda.OutOfMemoryError``, a heartbeat of
    ``memory_reserved()`` under the budget reads no violation; then the
    same process with its cap lifted (a workload ignoring its budget)
    holds one and a half budgets and its heartbeat reads as a
    violation in status.json.  One JSON object to ``out``."""
    budget = client.hbm_limit_bytes()
    row = dict(pid=os.getpid(), edits=edits, budget=budget,
               conf=os.environ.get("PYTORCH_CUDA_ALLOC_CONF"),
               total=torch.cuda.get_device_properties(0).total_memory)
    below = torch.empty(budget // 2, dtype=torch.uint8, device="cuda")
    torch.cuda.synchronize()
    row["below"] = below.numel()
    try:
        torch.empty(budget + budget // 2, dtype=torch.uint8, device="cuda")
        row["above"] = "allocated"
    except torch.cuda.OutOfMemoryError as e:
        row["above"] = "OutOfMemoryError"
        row["oom"] = str(e).splitlines()[0][:240]
    row["reserved_under"] = torch.cuda.memory_reserved()
    t = time.time()
    client.heartbeat(hbm_bytes_in_use=row["reserved_under"])
    status = await_status(client.dir, t, lambda s: True)
    row["under"] = [v for v in status.get("violations", [])
                    if v.get("worker") == "hbm"]
    torch.cuda.set_per_process_memory_fraction(1.0)
    over = torch.empty(budget + budget // 2, dtype=torch.uint8,
                       device="cuda")
    torch.cuda.synchronize()
    row["reserved_over"] = torch.cuda.memory_reserved()
    t = time.time()
    client.heartbeat(hbm_bytes_in_use=row["reserved_over"])
    status = await_status(client.dir, t, lambda s: any(
        v.get("worker") == "hbm" for v in s.get("violations", [])))
    row["over"] = [v for v in status.get("violations", [])
                   if v.get("worker") == "hbm"]
    client.unregister()
    del below, over
    Path(out).write_text(json.dumps(row))


def coord_replica_worker(spec: str, out: str) -> None:
    """phase_coordination (e), in a child with its coordinated claim's
    env: the 154M paged engine in bf16 at full width and depth; the same
    requests drained without a lease (the reference), then through a
    ``FleetGateway`` over a ``ReplicaManager`` whose ``lease_factory``
    builds ``DraChipLease`` from the claim's env and mounts (``spec``, a
    JSON file); the health source is the live backend's view with the
    card optionally reported failed, mapped to UUIDs by
    ``card_health_source`` over the discovered topology.  Retires the
    serving replica, adds one, reports the card failed and steps the
    gateway.  One JSON object to ``out``."""
    from k8s_dra_driver_tpu_torch.coordclient.client import \
        HEARTBEAT_INTERVAL_S
    from k8s_dra_driver_tpu_torch.discovery import SysfsBackend
    from k8s_dra_driver_tpu_torch.gateway import (DraChipLease, FleetGateway,
                                                  ReplicaManager,
                                                  card_health_source)
    from k8s_dra_driver_tpu_torch.models.serving import (Request,
                                                         ServingEngine)
    from k8s_dra_driver_tpu_torch.ops import flash_attention as fa
    from k8s_dra_driver_tpu_torch.ops import paged_attention as pa
    claim = json.loads(Path(spec).read_text())
    cfg, params = serving_model()
    reqs = [Request(uid=f"lease{i}", prompt=r.prompt, max_new=LEASE_NEW)
            for i, r in enumerate(s8_r24(cfg.vocab)[:LEASE_REQS])]
    backend = SysfsBackend("/")
    topology = backend.enumerate()
    reported: dict = {}

    def plugin_view() -> dict:
        return {**backend.health(), **reported}

    def engine(name):
        return ServingEngine(params, cfg, slots=LEASE_REQS,
                             kv_layout="paged")

    mgr = ReplicaManager(
        engine, replicas=1,
        health_source=card_health_source(plugin_view, topology),
        lease_factory=lambda name: DraChipLease(
            claim["env"], claim["mounts"], name=name))
    t_acquire = time.time()
    r0 = mgr.replicas[0]
    ctl = r0.lease.client.dir / "ctl"
    row = dict(pid=os.getpid(), chip=r0.chip, lease_chips=r0.lease.chips,
               coordination_dir=str(r0.lease.client.dir),
               registered=(ctl / "r0.json").exists())
    ref_engine = engine("ref")
    for r in reqs:
        ref_engine.submit(r)
    ref = {f.uid: np.asarray(f.tokens).tolist() for f in ref_engine.run()}
    del ref_engine
    # the pump heartbeats a lease once HEARTBEAT_INTERVAL_S has passed
    time.sleep(max(0.0, t_acquire + HEARTBEAT_INTERVAL_S + 0.1
                   - time.time()))
    gw = FleetGateway(mgr, queue_capacity=8, auto_replace=False)
    for r in reqs:
        gw.submit(r)
    torch.cuda.synchronize()
    zero_serving_counts(fa, pa)
    t0 = time.perf_counter()
    done = gw.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    row["counts"] = kernel_snapshot(fa, pa)
    reg = json.loads((ctl / "r0.json").read_text())
    row.update(reg=reg, wall_s=wall, finished=len(done))
    tokens = {g.uid: np.asarray(gw.results[g.uid].tokens).tolist()
              for g in done}
    row["byte_equal"] = sum(tokens.get(u) == t for u, t in ref.items())
    row["generated"] = sum(len(gw.results[g.uid].tokens)
                           - gw.results[g.uid].n_prompt for g in done)
    mgr.begin_drain(r0)
    mgr.retire(r0)
    row["after_retire"] = (ctl / "r0.json").exists()
    r1 = mgr.add_replica()
    row["r1"] = dict(name=r1.name, chip=r1.chip,
                     registered=(ctl / f"{r1.name}.json").exists())
    minor = next(c.index for c in topology.chips if c.uuid == r1.chip)
    reported[minor] = "reported failed"
    gw.step()
    row["r1"].update(state=r1.state, after_health=(
        ctl / f"{r1.name}.json").exists(), counts=mgr.counts())
    Path(out).write_text(json.dumps(row))


def coordination_env(view: dict) -> dict:
    """A child's environment under a claim: this process's without
    ``CUDA_VISIBLE_DEVICES``, with the claim's env applied, every value
    that names a container path of the claim's mounts rewritten to its
    host path (a host process cannot bind-mount), and the checkout on
    ``PYTHONPATH``."""
    from k8s_dra_driver_tpu_torch.gateway import resolve_container_path
    root = Path(__file__).resolve().parent
    env = {k: v for k, v in os.environ.items()
           if k != "CUDA_VISIBLE_DEVICES"}
    env.update({k: resolve_container_path(v, view["mounts"])
                for k, v in view["env"].items()})
    env["PYTHONPATH"] = os.pathsep.join(
        [str(root)] + [p for p in os.environ.get("PYTHONPATH", "")
                       .split(os.pathsep) if p])
    return env


class CoordinatorPods:
    """This script as the kubelet of coordinator Deployments: each one
    the port's plugin creates is run as a real process, ``python -m
    k8s_dra_driver_tpu_torch.cmd.coordinatord`` with the rendered args
    and env, container paths mapped to host paths through its volumes;
    the Deployment is marked ready only once the daemon's ready file
    exists, and its process is stopped when the Deployment is deleted
    (and by ``stop_all``)."""

    def __init__(self, cluster, logs: Path):
        self.cluster = cluster
        self.logs = logs
        self.procs: dict[str, subprocess.Popen] = {}
        self.dirs: dict[str, Path] = {}
        self.errors: list[str] = []
        self._lock = threading.Lock()
        self._unwatch = cluster.watch("Deployment", self._on_event)

    def _on_event(self, event, obj) -> None:
        name = obj.metadata.name
        if event == "DELETED":
            self._stop(name)
            return
        if event != "ADDED" or obj.ready:
            return
        pod = obj.spec["template"]["spec"]
        ctr = pod["containers"][0]
        if ctr.get("command") != COORD_COMMAND:
            self.errors.append(f"{name}: command {ctr.get('command')}")
            return
        vols = {v["name"]: v["hostPath"]["path"] for v in pod["volumes"]}
        mounts = [{"containerPath": m["mountPath"],
                   "hostPath": vols[m["name"]]}
                  for m in ctr.get("volumeMounts", [])]
        from k8s_dra_driver_tpu_torch.gateway import resolve_container_path
        args = []
        for arg in ctr.get("args", []):
            flag, eq, value = arg.partition("=")
            args.append(f"{flag}={resolve_container_path(value, mounts)}"
                        if eq else arg)
        cdir = Path(next(a.split("=", 1)[1] for a in args
                         if a.startswith("--coordination-dir=")))
        env = dict(os.environ, **{e["name"]: e["value"]
                                  for e in ctr.get("env", [])})
        log = open(self.logs / f"{name}.log", "w")
        proc = subprocess.Popen(
            [sys.executable, "-m", DAEMON_MODULE, *args],
            cwd=Path(__file__).resolve().parent, env=env, stdout=log,
            stderr=subprocess.STDOUT)
        log.close()
        with self._lock:
            self.procs[name], self.dirs[name] = proc, cdir
        threading.Thread(target=self._mark_ready, args=(obj, proc, cdir),
                         daemon=True).start()

    def _mark_ready(self, obj, proc, cdir: Path) -> None:
        deadline = time.time() + 30
        while time.time() < deadline and proc.poll() is None:
            if (cdir / "ready").exists():
                obj.ready_replicas = obj.replicas
                self.cluster.update(obj)
                return
            time.sleep(0.01)
        self.errors.append(f"{obj.metadata.name}: daemon rc {proc.poll()}, "
                           f"no ready file in 30 s")

    def _stop(self, name: str) -> None:
        with self._lock:
            proc = self.procs.pop(name, None)
        if proc is None:
            return
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(10)
        if proc.returncode != 0:
            self.errors.append(f"{name}: daemon exited {proc.returncode}")

    def stop_all(self) -> None:
        self._unwatch()
        for name in list(self.procs):
            self._stop(name)


def k1_children_check(label: str, rows: dict, uuid: str) -> None:
    """Each K1 child saw one card, the claimed one, held K1 to its plain
    version, and every loop launch was K1's tensor-core route."""
    for name, row in rows.items():
        if (row["count"] != 1 or row["uuid"] != uuid
                or row["err"] > row["tol"]
                or row["launches"] != row["tc_launches"]
                or row["launches"] != COORD_BATCH * len(row["batches"])
                or not row["batches"]):
            fail(f"coordination ({label}): child {name}: "
                 f"{ {k: v for k, v in row.items() if k != 'batches'} }, "
                 f"{len(row['batches'])} batches")


def overlap_s(a: list, b: list) -> float:
    """Total time two lists of (start, end) intervals, each sorted and
    disjoint within itself, overlap."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def kill_children(children: list, outs: list) -> None:
    """Every child this phase started, and each K1 worker's process
    group (the gate starts it in a session of its own)."""
    for p in children:
        if p.poll() is None:
            p.kill()
        p.wait()
    for out in outs:
        pid_file = Path(str(out) + ".pid")
        if pid_file.exists():
            try:
                os.killpg(int(pid_file.read_text()), signal.SIGKILL)
            except (ProcessLookupError, PermissionError, ValueError):
                pass


def phase_coordination() -> dict:
    """The port's controller and coordination on the live card (see the
    module docstring, 2d).  Returns the kernels launched on its main
    paths (the K1 children's loops and the leased replica's serving)."""
    import logging

    import grpc

    from k8s_dra_driver_tpu_torch import SLICE_LABEL
    from k8s_dra_driver_tpu_torch.allocator import Allocator
    from k8s_dra_driver_tpu_torch.api import resource
    from k8s_dra_driver_tpu_torch.api.classes import standard_device_classes
    from k8s_dra_driver_tpu_torch.cluster import FakeCluster, Node
    from k8s_dra_driver_tpu_torch.cmd import controller as controller_cmd
    from k8s_dra_driver_tpu_torch.cmd import plugin as plugin_cmd
    from k8s_dra_driver_tpu_torch.coordclient import schedule as sched
    from k8s_dra_driver_tpu_torch.discovery import GENERATIONS
    from k8s_dra_driver_tpu_torch.proto import DRAPluginStub, dra_pb2
    t0 = time.perf_counter()
    card = card_line()
    root = Path(__file__).resolve().parent
    tmp = Path(tempfile.mkdtemp(prefix="cco-", dir="/tmp"))
    saved_log = (logging.getLogger().handlers[:],
                 logging.getLogger().level)
    plugin_root, cdi_root = tmp / "plugin", tmp / "cdi"
    argv = ["--node-name", COORD_NODE, "--plugin-root", str(plugin_root),
            "--registrar-root", str(tmp / "reg"), "--cdi-root",
            str(cdi_root), "--fake-cluster", "--discovery", "auto",
            "--health-interval", "0", "--coordinator-image",
            "registry.local/tpu-dra-driver:smoke", "-v", "0"]
    h100 = GENERATIONS["h100"]
    out = {"launches": {"flash_fwd": 0, "flash_fwd_tc": 0,
                        "paged_decode": 0}}
    children, outs = [], []
    me = os.getpid()

    def line(part: str, text: str) -> None:
        print(f"coordination ({part}) [{card}, "
              f"{time.perf_counter() - t0:.2f} s into the phase]: {text}",
              flush=True)

    cluster = FakeCluster()
    cluster.create(Node(metadata=resource.ObjectMeta(name=COORD_NODE)))
    classes = standard_device_classes()
    for cls in classes.values():
        cluster.create(cls)
    (tmp / "logs").mkdir()
    pods = CoordinatorPods(cluster, tmp / "logs")
    plugin = ctl = None
    try:
        plugin = plugin_thread(plugin_cmd, argv, cluster)
        (rslice,) = cluster.list("ResourceSlice")
        chips = {d.name: d for d in rslice.devices
                 if d.attributes.get("type") == "chip"}

        # (a) the controller over the same cluster
        ctl_args = controller_cmd.build_parser().parse_args(
            ["--device-classes", "podslice,rendezvous", "-v", "0"])
        ctl_ready, ctl_stop = threading.Event(), threading.Event()
        ctl_t = threading.Thread(
            target=controller_cmd.run, args=(ctl_args,),
            kwargs=dict(client=cluster, ready_event=ctl_ready,
                        stop_event=ctl_stop), daemon=True)
        ctl_t.start()
        ctl = (ctl_t, ctl_stop)
        if not ctl_ready.wait(30):
            fail("coordination (a): the controller was not ready in 30 s")

        def gang_pools():
            return [s for s in cluster.list("ResourceSlice")
                    if s.node_selector]

        card_node = cluster.get("Node", "", COORD_NODE)
        if gang_pools() or SLICE_LABEL in card_node.metadata.labels:
            fail(f"coordination (a): the card's node has labels "
                 f"{card_node.metadata.labels} and gang pools "
                 f"{[s.metadata.name for s in gang_pools()]}")
        label = "slice-smoke.2x2"
        cluster.create(Node(metadata=resource.ObjectMeta(
            name="tpu-w0", labels={SLICE_LABEL: label})))
        (pool,) = gang_pools()
        kinds = sorted(d.attributes.get("type") for d in pool.devices)
        channels = [d for d in pool.devices
                    if d.attributes.get("type") == "rendezvous"]
        if (pool.node_selector != {SLICE_LABEL: label}
                or kinds.count("podslice") != 1 or len(channels) != 128
                or len(pool.devices) != 129):
            fail(f"coordination (a): pool {pool.pool.name} selector "
                 f"{pool.node_selector}, kinds {sorted(set(kinds))}, "
                 f"{len(channels)} channels")
        node = cluster.get("Node", "", "tpu-w0")
        node.metadata.labels.pop(SLICE_LABEL)
        cluster.update(node)
        gone = not gang_pools()
        cluster.create(Node(metadata=resource.ObjectMeta(
            name="tpu-w1", labels={SLICE_LABEL: label})))
        again = len(gang_pools())
        ctl_stop.set()
        ctl_t.join(timeout=30)
        ctl = None
        if not gone or again != 1 or ctl_t.is_alive() or gang_pools():
            fail(f"coordination (a): pool gone on unlabel {gone}, back "
                 f"{again}, controller stopped {not ctl_t.is_alive()}, "
                 f"left {[s.metadata.name for s in gang_pools()]}")
        line("a", f"controller run(): node tpu-w0 labelled {label} -> "
             f"pool {pool.pool.name}: 1 podslice + {len(channels)} "
             f"channel devices (channel-{channels[0].attributes['channelId']}"
             f"..), selector {pool.node_selector}; unlabelled: pool gone; "
             f"relabelled on tpu-w1: back; stop: cleaned up; the card's "
             f"node {COORD_NODE} (labels {card_node.metadata.labels}) "
             f"got no pool")

        # the claims: the port's allocator places each on the card
        sock = plugin_root / "plugin.sock"
        stub = DRAPluginStub(grpc.insecure_channel(f"unix://{sock}"))

        def allocated(name, sharing):
            c = resource.ResourceClaim(
                metadata=resource.ObjectMeta(name=name, namespace="default",
                                             uid=f"uid-{name}"),
                spec=resource.ResourceClaimSpec(
                    devices=resource.DeviceClaim(
                        requests=[resource.DeviceRequest(
                            name="r0", device_class_name="tpu.google.com",
                            selectors=[resource.DeviceSelector(
                                cel=f'device.attributes["productName"] == '
                                    f'"{h100.product_name}"')])],
                        config=[resource.ClaimConfig(
                            opaque=resource.OpaqueConfig(
                                driver="tpu.google.com", parameters={
                                    "apiVersion": "tpu.google.com/v1alpha1",
                                    "kind": "TpuChipConfig",
                                    "sharing": sharing}))])))
            c.status.allocation = Allocator().allocate(
                c, [rslice], classes, nodes=cluster.list("Node"))
            cluster.create(c)
            return c

        def grpc_call(verb, claim):
            req_cls = (dra_pb2.NodePrepareResourcesRequest if verb ==
                       "prepare" else dra_pb2.NodeUnprepareResourcesRequest)
            fn = (stub.NodePrepareResources if verb == "prepare"
                  else stub.NodeUnprepareResources)
            c0 = time.perf_counter()
            resp = fn(req_cls(claims=[dra_pb2.Claim(
                uid=claim.metadata.uid, namespace="default",
                name=claim.metadata.name)]), timeout=60)
            res = resp.claims[claim.metadata.uid]
            if res.error:
                fail(f"coordination: {verb} of {claim.metadata.name}: "
                     f"{res.error}; daemons: {pods.errors}")
            return res, (time.perf_counter() - c0) * 1e3

        def prepared(name, sharing):
            claim = allocated(name, sharing)
            (pick,) = claim.status.allocation.results
            res, ms = grpc_call("prepare", claim)
            view = cdi_apply(cdi_root, [i for d in res.devices
                                        for i in d.cdi_device_ids])
            return claim, pick, view, ms

        def coord_dir(view) -> Path:
            from k8s_dra_driver_tpu_torch.gateway import \
                resolve_container_path
            return Path(resolve_container_path(
                view["env"]["TPU_COORDINATOR_DIR"], view["mounts"]))

        def wait_children(procs, label):
            for p in procs:
                try:
                    rc = p.wait(CHILD_S)
                except subprocess.TimeoutExpired:
                    fail(f"coordination ({label}): a child ran past "
                         f"{CHILD_S} s")
                if rc:
                    tail = p.stdout.read()[-3000:] if p.stdout else ""
                    fail(f"coordination ({label}): {p.args[:6]} exited "
                         f"{rc}: {tail}")

        def k1_child(env, name, path, seconds, gated_by):
            outs.append(path)
            cmd = [sys.executable, "-m", GATE_MODULE, "exec"]
            if gated_by == "coordinator":
                cmd += ["--name", name]
            cmd += ["--", sys.executable, "-c",
                    "import sys, chip_smoke; chip_smoke.coord_k1_batches("
                    "sys.argv[1], float(sys.argv[2]))", str(path),
                    str(seconds)]
            p = subprocess.Popen(cmd, cwd=root, env=env,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
            children.append(p)
            return p

        # (b) a coordinated claim, the real daemon, two gated K1 children
        policy_files = [plugin_root / "policy" / f"chip{name[5:]}.json"
                        for name in chips]
        for path in policy_files:
            path.write_text(json.dumps({"preemptionMs": COORD_POLICY_MS}))
        co, pick, view, co_ms = prepared("coord", {
            "strategy": "Coordinated",
            "coordinated": {"dutyCyclePercent": 100}})
        uuid = chips[pick.device].attributes["uuid"]
        minor = int(pick.device.removeprefix("chip-"))
        node_path = f"/dev/nvidia{minor}"
        cdir = coord_dir(view)
        if view["env"].get("CUDA_VISIBLE_DEVICES") != uuid or not (
                cdir / "ready").exists() or len(pods.procs) != 1:
            fail(f"coordination (b): env {view['env']}, ready "
                 f"{(cdir / 'ready').exists()}, daemons {list(pods.procs)} "
                 f"{pods.errors}")
        env = coordination_env(view)
        go = tmp / "go"
        holder = subprocess.Popen(
            [sys.executable, "-c", "import sys, chip_smoke; "
             "chip_smoke.coord_holder(sys.argv[1])", str(go)], cwd=root,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        children.append(holder)
        b_outs = {w: tmp / f"b-{w}.json" for w in ("w0", "w1")}
        gates = [k1_child(env, w, path, COORD_LOOP_S, "coordinator")
                 for w, path in b_outs.items()]
        # the published two-worker schedule (a 1000 ms cycle: the node
        # policy) and the status while both serve
        schedule, deadline = {}, time.time() + 60
        while time.time() < deadline:
            schedule = json.loads((cdir / "schedule.json").read_text())
            if (len(schedule.get("slots", [])) == 2
                    and schedule.get("cycleMs") == COORD_POLICY_MS):
                break
            time.sleep(0.05)
        else:
            fail(f"coordination (b): schedule {schedule}")
        while time.time() < deadline and not all(
                Path(str(p) + ".pid").exists() for p in b_outs.values()):
            time.sleep(0.05)
        status_both = await_status(cdir, time.time(),
                                   lambda s: s["workers"] == 2, 30)
        wait_children(gates, "b")
        rows = {w: json.loads(p.read_text()) for w, p in b_outs.items()}
        k1_children_check("b", rows, uuid)
        slots = {s["worker"]: s for s in schedule["slots"]}
        # the span both loops ran (one child's gate unregisters at its
        # end, which republishes the other's window as the whole cycle)
        lo = max(r["batches"][0][0] for r in rows.values())
        hi = min(r["batches"][-1][1] for r in rows.values())
        cycle, epoch = schedule["cycleMs"], schedule["epochMs"]
        # one batch: the longest that no stop interrupted (a stop lasts
        # the other worker's whole window)
        half = min(s["windowMs"] for s in schedule["slots"]) / 2e3
        batch_s = max((b - a for r in rows.values()
                       for a, b in r["batches"] if b - a < half), default=0.0)
        slack_ms = (batch_s + GATE_REEVAL_S) * 1e3
        shares, strict = {}, {}
        for w, row in rows.items():
            s = slots[w]
            inside = [(a, b) for a, b in row["batches"] if lo <= b <= hi]
            late = [b for a, b in inside
                    if (b * 1e3 - epoch - s["offsetMs"]) % cycle
                    >= s["windowMs"] + slack_ms]
            strict[w] = sum(sched.active_worker(schedule, b * 1e3) == w
                            for a, b in inside) / max(1, len(inside))
            shares[w] = len(inside)
            if late or len(inside) < 10:
                fail(f"coordination (b): {w}: {len(late)} of {len(inside)} "
                     f"batches completed outside its window {s} plus "
                     f"{slack_ms:.1f} ms")
        total = sum(shares.values())
        others = [v for v in status_both.get("violations", [])
                  if v.get("pid") != me]
        mine = [v for v in status_both.get("violations", [])
                if v.get("pid") == me]
        if (status_both.get("workers") != 2 or others
                or any(v.get("devices") != [node_path] for v in mine)):
            fail(f"coordination (b): status.json while both served "
                 f"{status_both}")
        # the ungated holder: opens the card now
        go.write_text("")
        if holder.stdout.readline().strip() != "open":
            fail(f"coordination (b): holder {holder.stdout.read()[-2000:]}")
        t_open = time.time()
        status_h = await_status(cdir, t_open, lambda s: any(
            v.get("pid") == holder.pid for v in s["violations"]), 20)
        seen = [v for v in status_h.get("violations", [])
                if v.get("pid") == holder.pid]
        holder.kill()
        holder.wait()
        if not seen or seen[0]["devices"] != [node_path] or seen[0][
                "type"] != "unregisteredDeviceHolder":
            fail(f"coordination (b): the ungated holder {holder.pid} was "
                 f"not reported on {node_path}: {status_h}")
        for w, row in rows.items():
            out["launches"]["flash_fwd"] += row["launches"]
            out["launches"]["flash_fwd_tc"] += row["tc_launches"]
        for path in policy_files:
            path.unlink()
        _, un_ms = grpc_call("unprepare", co)
        if pods.procs or pods.errors:
            fail(f"coordination (b): daemons after unprepare "
                 f"{list(pods.procs)} {pods.errors}")
        busy = {w: sum(b - a for a, b in r["batches"]
                       if lo <= b <= hi and b - a < half)
                for w, r in rows.items()}
        out["b"] = dict(shares=shares, strict=strict, slack_ms=slack_ms,
                        busy_s=busy)
        line("b", f"claim coord on {pick.device} ({uuid}), prepare over "
             f"gRPC {co_ms:.1f} ms (the daemon a real process, ready file "
             f"seen); schedule cycle {cycle} ms, windows "
             + ", ".join(f"{w} [{s['offsetMs']}, "
                         f"{s['offsetMs'] + s['windowMs']})"
                         for w, s in slots.items())
             + f"; gated K1 children (B=2 T=96 H=16 Hkv=4 D=64 causal "
             f"bf16, {COORD_BATCH} launches a batch, {COORD_LOOP_S} s "
             f"loops): batches while both ran "
             + ", ".join(f"{w} {n} ({n / max(1, total):.1%}), in its "
                         f"window without slack {strict[w]:.1%}"
                         for w, n in shares.items())
             + f"; seconds in uninterrupted batches "
             + ", ".join(f"{w} {v:.3f}" for w, v in busy.items())
             + f", all within the window plus {slack_ms:.1f} ms (one "
             f"batch + {GATE_REEVAL_S} s); K1 max|d| "
             + ", ".join(f"{w} {r['err']:.3g} (tol {r['tol']:.3g})"
                         for w, r in rows.items())
             + f"; status.json with both: workers 2, violations other "
             f"than this script's own process: none (this script holds a "
             f"CUDA context: "
             f"{[v['devices'] for v in mine] or 'not reported'}); the "
             f"ungated holder pid {holder.pid} reported as "
             f"{seen[0]['type']} on {seen[0]['devices']} "
             f"{time.time() - t_open:.2f} s after it opened the card; "
             f"unprepare {un_ms:.1f} ms stopped the daemon")

        # (c) a device-memory limit on the card
        hb, _, hview, _ = prepared("hbm", {
            "strategy": "Coordinated",
            "coordinated": {"dutyCyclePercent": 100,
                            "perDeviceHbmLimits": {"default": COORD_HBM}}})
        total = torch.cuda.get_device_properties(0).total_memory
        hbm_out = tmp / "c.json"
        hchild = subprocess.run(
            [sys.executable, "-c", HBM_CHILD, str(hbm_out), str(total)],
            cwd=root, env=coordination_env(hview), capture_output=True,
            text=True, timeout=CHILD_S)
        if hchild.returncode:
            fail(f"coordination (c): child exited {hchild.returncode}: "
                 f"{hchild.stdout[-2000:]}{hchild.stderr[-3000:]}")
        hrow = json.loads(hbm_out.read_text())
        over = hrow["over"]
        if (hrow["budget"] != COORD_HBM_BYTES
                or hrow["above"] != "OutOfMemoryError" or hrow["under"]
                or len(over) != 1 or over[0]["action"] != "report"
                or over[0]["limitBytes"] != COORD_HBM_BYTES
                or over[0]["usedBytes"] != hrow["reserved_over"]
                or hrow["reserved_over"] <= COORD_HBM_BYTES):
            fail(f"coordination (c): {hrow}")
        grpc_call("unprepare", hb)
        out["c"] = hrow
        line("c", f"claim hbm, limit {COORD_HBM} on {uuid}: the child's "
             f"budget {hrow['budget']} B of total {hrow['total']} B as "
             f"{hrow['edits']} (set before torch starts); "
             f"{hrow['below']} B allocated, {COORD_HBM_BYTES * 3 // 2} B "
             f"raised {hrow['above']} ({hrow['oom']}); heartbeat of "
             f"memory_reserved() {hrow['reserved_under']} B: no violation; "
             f"cap lifted, {hrow['reserved_over']} B reserved: status.json "
             f"{over[0]}")

        # (d) two time-sliced claims on the card
        sliced = {"strategy": "TimeSlicing",
                  "timeSlicing": {"interval": "Long"}}
        d_outs, d_claims = {}, []
        gates = []
        for name in ("ts-a", "ts-b"):
            claim, tpick, tview, _ = prepared(name, sliced)
            d_claims.append(claim)
            if (tpick.device != pick.device or tview["env"].get(
                    "CUDA_VISIBLE_DEVICES") != uuid
                    or "TPU_VISIBLE_CHIPS" in tview["env"]):
                fail(f"coordination (d): {name} on {tpick.device}, env "
                     f"{tview['env']}")
            d_outs[name] = tmp / f"d-{name}.json"
            gates.append(k1_child(coordination_env(tview), name,
                                  d_outs[name], TS_LOOP_S, "timeshare"))
        quantum = int(tview["env"]["TPU_RUNTIME_PREEMPTION_MS"])
        wait_children(gates, "d")
        drows = {n: json.loads(p.read_text()) for n, p in d_outs.items()}
        k1_children_check("d", drows, uuid)
        lock = plugin_root / "timeshare" / f"{uuid}.lock"
        d_med = float(np.median([b - a for r in drows.values()
                                 for a, b in r["batches"]]))
        # a batch is uninterrupted when it took under half a quantum: a
        # stop inside it lasts the other claim's whole quantum
        whole = {n: [(a, b) for a, b in r["batches"]
                     if b - a < quantum / 2e3] for n, r in drows.items()}
        (na, a_b), (nb, b_b) = whole.items()
        overlap = overlap_s(a_b, b_b)
        d_max = max((b - a for r in whole.values() for a, b in r),
                    default=0.0)
        if (overlap > d_max or len(a_b) < 10 or len(b_b) < 10
                or not lock.exists()):
            fail(f"coordination (d): uninterrupted batches {len(a_b)}, "
                 f"{len(b_b)}; their overlap {overlap * 1e3:.3f} ms "
                 f"against one batch {d_max * 1e3:.3f} ms; lock "
                 f"{lock.exists()}")
        for row in drows.values():
            out["launches"]["flash_fwd"] += row["launches"]
            out["launches"]["flash_fwd_tc"] += row["tc_launches"]
        for claim in d_claims:
            grpc_call("unprepare", claim)
        out["d"] = dict(overlap_ms=overlap * 1e3, batch_ms=d_max * 1e3,
                        whole={n: len(v) for n, v in whole.items()})
        line("d", f"claims ts-a, ts-b (TimeSlicing Long: quantum "
             f"{quantum} ms) both on {pick.device}, each child under the "
             f"gate with CUDA_VISIBLE_DEVICES={uuid}: lock {lock.name}; "
             f"batches {len(drows[na]['batches'])} and "
             f"{len(drows[nb]['batches'])} ({len(a_b)} and {len(b_b)} "
             f"uninterrupted, median {d_med * 1e3:.3f} ms); uninterrupted "
             f"batches of the two overlap {overlap * 1e3:.3f} ms in all "
             f"(one batch: {d_max * 1e3:.3f} ms)")

        # (e) a leased 154M replica
        lc, _, lview, _ = prepared("lease", {
            "strategy": "Coordinated",
            "coordinated": {"dutyCyclePercent": 100}})
        spec = tmp / "e-claim.json"
        spec.write_text(json.dumps(dict(env=lview["env"],
                                        mounts=lview["mounts"])))
        e_out = tmp / "e.json"
        env = dict(os.environ, **lview["env"],
                   PYTHONPATH=coordination_env(lview)["PYTHONPATH"])
        echild = subprocess.run(
            [sys.executable, "-c", "import sys, chip_smoke; "
             "chip_smoke.coord_replica_worker(sys.argv[1], sys.argv[2])",
             str(spec), str(e_out)], cwd=root, env=env,
            capture_output=True, text=True, timeout=CHILD_S)
        if echild.returncode:
            fail(f"coordination (e): child exited {echild.returncode}: "
                 f"{echild.stdout[-2000:]}{echild.stderr[-3000:]}")
        erow = json.loads(e_out.read_text())
        counts = erow["counts"]
        reg = erow["reg"]
        r1 = erow["r1"]
        if (erow["chip"] != uuid or erow["lease_chips"] != [uuid]
                or Path(erow["coordination_dir"]) != coord_dir(lview)
                or not erow["registered"] or reg.get("pid") != erow["pid"]
                or reg.get("heartbeatAtMs", 0) <= reg["registeredAtMs"]
                or erow["finished"] != LEASE_REQS
                or erow["byte_equal"] != LEASE_REQS
                or erow["after_retire"]
                or counts["flash_fwd"] <= 0 or counts["paged_decode"] <= 0
                or counts["flash_fwd_tc"] != counts["flash_fwd"]
                or r1["chip"] != uuid or not r1["registered"]
                or r1["state"] != "dead" or r1["after_health"]
                or r1["counts"]["dead"] != 1):
            fail(f"coordination (e): {erow}")
        grpc_call("unprepare", lc)
        for name in ("flash_fwd", "flash_fwd_tc", "paged_decode"):
            out["launches"][name] += counts[name]
        out["e"] = dict(tokens_per_s=erow["generated"] / erow["wall_s"],
                        wall_s=erow["wall_s"], counts=counts)
        line("e", f"claim lease on {uuid}; a child with its env builds the "
             f"154M paged engine (bf16, full width and depth); "
             f"DraChipLease chips {erow['lease_chips']}, replica chip label "
             f"{erow['chip']}, registered in {erow['coordination_dir']} "
             f"(resolved through the claim's mounts) and heartbeaten "
             f"(heartbeatAtMs - registeredAtMs = "
             f"{reg['heartbeatAtMs'] - reg['registeredAtMs']:.0f} ms); "
             f"{LEASE_REQS} greedy requests x {LEASE_NEW} new tokens "
             f"through FleetGateway: {erow['generated']} tokens in "
             f"{erow['wall_s']:.3f} s = {out['e']['tokens_per_s']:.1f} "
             f"tokens/s, {erow['byte_equal']}/{LEASE_REQS} byte-equal to "
             f"the same engine without a lease, launches {counts}; after "
             f"retire the registration is gone; {r1['name']} added "
             f"(registered), the card reported failed: {r1['name']} "
             f"{r1['state']}, registration gone, pool {r1['counts']}")
    finally:
        if ctl is not None:
            ctl[1].set()
            ctl[0].join(timeout=30)
        kill_children(children, outs)
        if plugin is not None:
            plugin_stop(*plugin)
        pods.stop_all()
        root_log = logging.getLogger()
        root_log.handlers[:] = saved_log[0]
        root_log.setLevel(saved_log[1])
        shutil.rmtree(tmp, ignore_errors=True)
    if pods.errors:
        fail(f"coordination: coordinator pods {pods.errors}")
    out["wall_s"] = time.perf_counter() - t0
    print(f"coordination [{card}]: phase wall {out['wall_s']:.2f} s; (b) "
          f"batches {out['b']['shares']}, in-window shares "
          f"{ {w: round(v, 4) for w, v in out['b']['strict'].items()} }; "
          f"(c) over the limit: {out['c']['above']}; (d) overlap "
          f"{out['d']['overlap_ms']:.3f} ms; (e) "
          f"{out['e']['tokens_per_s']:.1f} tokens/s; launches "
          f"{out['launches']}", flush=True)
    return out


DEMO_NODE = "h100-demo"
#: the H100 demo specs the phase applies (every file of demo/specs/h100)
DEMO_SPECS = ("tpu-test1", "tpu-test2", "tpu-test3", "tpu-test5",
              "tpu-test6", "tpu-test-coordinator", "tpu-test-enforced",
              "tpu-test-serve")
#: the longest a pod's containers may run (the serve pod's two probes
#: and the gated pods' import under a 50% window are the longest)
DEMO_CHILD_S = 300.0
#: the serve pod's K1 calls (tpu-test-serve.yaml: 8 heads of 64 over 2
#: KV heads, bf16, causal): decode_probe's prefill of its batch of 4 at
#: its default prompt of 128, and serving_probe's fills, each prompt
#: length's group padded to the 4 slots (48 and its 1/2, 3/4 and 1/4).
#: phase_flash holds K1 at each; phase_demo holds the pod's reported
#: widths to these
DEMO_SERVE_K1 = dict(b=4, ts=(128, 48, 36, 24, 12), h=8, h_kv=2, d=64)


class DemoPod:
    """One container of a demo pod, run as this host's child process:
    its command and args with ``python`` this interpreter, its
    environment the given one; its standard output's lines read on a
    thread (the first line's arrival and the end stamped on this
    process's clock), its standard error on another."""

    def __init__(self, key: str, argv: list[str], env: dict, cwd: Path):
        self.key = key
        self.lines: list[str] = []
        self.errors: list[str] = []
        self.first_at = self.end_at = None
        self.start_at = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable if a == "python" else a for a in argv],
            cwd=cwd, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, bufsize=1)
        self._readers = [threading.Thread(target=self._read, daemon=True),
                         threading.Thread(target=self._read_errors,
                                          daemon=True)]
        for t in self._readers:
            t.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            if self.first_at is None:
                self.first_at = time.perf_counter()
            self.lines.append(line.rstrip("\n"))
        self.end_at = time.perf_counter()

    def _read_errors(self) -> None:
        for line in self.proc.stderr:
            self.errors.append(line.rstrip("\n"))

    def wait(self, label: str) -> str:
        try:
            rc = self.proc.wait(DEMO_CHILD_S)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            fail(f"demo {label}: {self.key} ran past {DEMO_CHILD_S} s")
        for t in self._readers:
            t.join(timeout=30)
        if rc:
            fail(f"demo {label}: {self.key} exited {rc}: "
                 + "\n".join(self.lines + self.errors)[-4000:])
        return "\n".join(self.lines)

    def line(self, prefix: str) -> str:
        hits = [ln for ln in self.lines if ln.startswith(prefix)]
        if len(hits) != 1:
            fail(f"demo: {self.key} printed {len(hits)} lines starting "
                 f"{prefix!r}: {self.lines}")
        return hits[0]


def phase_demo() -> dict:
    """The H100 demo specs on the live card (see the module docstring,
    2e).  Returns the serve pod's K1 launches, its tokens/s and the
    claim-created to first-line latencies."""
    import logging

    import grpc

    from k8s_dra_driver_tpu_torch.allocator import (AllocationError,
                                                    allocate_claim)
    from k8s_dra_driver_tpu_torch.api import resource
    from k8s_dra_driver_tpu_torch.api.classes import standard_device_classes
    from k8s_dra_driver_tpu_torch.cluster import FakeCluster, Node, specs
    from k8s_dra_driver_tpu_torch.cmd import plugin as plugin_cmd
    from k8s_dra_driver_tpu_torch.proto import DRAPluginStub, dra_pb2
    t0 = time.perf_counter()
    card = card_line()
    root = Path(__file__).resolve().parent
    specs_dir = root / "demo" / "specs" / "h100"
    tmp = Path(tempfile.mkdtemp(prefix="cdm-", dir="/tmp"))
    saved_log = (logging.getLogger().handlers[:],
                 logging.getLogger().level)
    cdi_root = tmp / "cdi"
    argv = ["--node-name", DEMO_NODE, "--plugin-root", str(tmp / "plugin"),
            "--registrar-root", str(tmp / "reg"), "--cdi-root",
            str(cdi_root), "--fake-cluster", "--discovery", "auto",
            "--health-interval", "0", "--coordinator-image",
            "tpu-dra-driver-torch:smoke", "-v", "0"]
    cuda = {}
    for i in range(torch.cuda.device_count()):
        props = torch.cuda.get_device_properties(i)
        cuda["GPU-" + str(props.uuid)] = props.name
    out = {"launches": {"flash_fwd": 0, "flash_fwd_tc": 0},
           "latency_ms": {}}
    children: list[DemoPod] = []

    def line(spec: str, text: str) -> None:
        print(f"demo {spec} [{card}, {time.perf_counter() - t0:.2f} s "
              f"into the phase]: {text}", flush=True)

    on_disk = sorted(p.stem for p in specs_dir.glob("*.yaml"))
    if on_disk != sorted(DEMO_SPECS):
        fail(f"demo: {specs_dir} holds {on_disk}; the phase runs "
             f"{sorted(DEMO_SPECS)}")
    cluster = FakeCluster()
    cluster.create(Node(metadata=resource.ObjectMeta(name=DEMO_NODE)))
    for cls in standard_device_classes().values():
        cluster.create(cls)
    (tmp / "logs").mkdir()
    pods = CoordinatorPods(cluster, tmp / "logs")
    plugin = None
    try:
        plugin = plugin_thread(plugin_cmd, argv, cluster)
        (rslice,) = cluster.list("ResourceSlice")
        uuid_of = {d.name: d.attributes["uuid"] for d in rslice.devices
                   if d.attributes.get("type") == "chip"}
        if set(uuid_of.values()) != set(cuda):
            fail(f"demo: published cards {uuid_of}, torch.cuda {cuda}")
        stub = DRAPluginStub(grpc.insecure_channel(
            f"unix://{tmp / 'plugin' / 'plugin.sock'}"))

        def grpc_call(verb, claim):
            req_cls = (dra_pb2.NodePrepareResourcesRequest if verb ==
                       "prepare" else dra_pb2.NodeUnprepareResourcesRequest)
            fn = (stub.NodePrepareResources if verb == "prepare"
                  else stub.NodeUnprepareResources)
            resp = fn(req_cls(claims=[dra_pb2.Claim(
                uid=claim.metadata.uid, namespace=claim.metadata.namespace,
                name=claim.metadata.name)]), timeout=60)
            res = resp.claims[claim.metadata.uid]
            if res.error:
                fail(f"demo: {verb} of {claim.metadata.name}: {res.error}; "
                     f"coordinator pods {pods.errors}")
            return res

        class Applied:
            """A spec applied (``cluster/specs.py``): its claims created
            as the claim controller would (a template's claim for each
            pod that names it), each stamped with its creation on this
            clock."""

            def __init__(self, name: str):
                self.name = name
                self.created: dict[str, float] = {}
                spec = specs.SpecClaims(
                    specs.load(specs_dir / f"{name}.yaml"), self._create)
                self.pods = spec.pods
                #: the spec's own ResourceClaims by name
                self.claims = spec.shared
                self.of_pod = {}
                for pod in self.pods:
                    (claim,) = spec.claims_for(pod)
                    self.of_pod[pod["metadata"]["name"]] = claim

            def _create(self, claim):
                c = cluster.create(claim)
                self.created[c.metadata.name] = time.perf_counter()
                return c

            def schedule(self, claim) -> str:
                """The port's allocator as the scheduler: the card's
                device name."""
                if claim.status.allocation is None:
                    allocate_claim(cluster, claim)
                (pick,) = {r.device for r in
                           claim.status.allocation.results}
                return pick

            def prepare(self, claim) -> dict:
                """gRPC prepare, the CDI edits applied; every device node
                must exist before a container starts."""
                res = grpc_call("prepare", claim)
                view = cdi_apply(cdi_root, [i for d in res.devices
                                            for i in d.cdi_device_ids])
                missing = [p for p in view["device_nodes"]
                           if not os.path.exists(p)]
                if missing:
                    fail(f"demo {self.name}: CDI device nodes {missing} "
                         f"missing on the host")
                return view

            def start(self, pod: dict, view: dict) -> list[DemoPod]:
                env = coordination_env(view)
                started = []
                for ctr in pod["spec"]["containers"]:
                    key = (ctr["name"] if len(pod["spec"]["containers"]) > 1
                           else pod["metadata"]["name"])
                    started.append(DemoPod(
                        f"{self.name}/{key}",
                        ctr["command"] + ctr.get("args", []), env, root))
                children.extend(started)
                return started

            def finish(self, started: list[DemoPod], claim, uuid: str
                       ) -> dict[str, str]:
                """Wait for the containers; each saw the one card named
                ``uuid`` (its first line, torch.cuda's name and UUID); its
                output printed and its latency from the claim's creation
                recorded."""
                outs = {}
                for p in started:
                    text = p.wait(self.name)
                    key = p.key.split("/", 1)[1]
                    first = p.lines[0] if p.lines else ""
                    tag = first.split(" ", 1)[0]
                    cards = json.loads(p.line(f"{tag} cuda:").split(
                        "cuda:", 1)[1])
                    if (not first.startswith(
                            f"{tag} CUDA_VISIBLE_DEVICES = {uuid}")
                            or cards != [[cuda[uuid], uuid]]):
                        fail(f"demo {p.key}: first line {first!r}, cuda "
                             f"{cards}; the claim's card {uuid}")
                    ms = (p.first_at - self.created[claim.metadata.name]) \
                        * 1e3
                    out["latency_ms"][p.key] = ms
                    for ln in p.lines:
                        line(self.name, f"{key}| {ln}")
                    line(self.name, f"{key}: exit 0, claim created -> first "
                         f"line {ms:.1f} ms (host clock), ran "
                         f"{p.end_at - p.start_at:.2f} s")
                    outs[key] = text
                return outs

            def delete(self, claim) -> None:
                grpc_call("unprepare", claim)
                cluster.delete("ResourceClaim", claim.metadata.namespace,
                               claim.metadata.name)

        def run_alone(a: Applied, pod_name: str):
            """One pod whose claim is its own: schedule, prepare, run."""
            claim = a.of_pod[pod_name]
            dev = a.schedule(claim)
            view = a.prepare(claim)
            pod = next(p for p in a.pods
                       if p["metadata"]["name"] == pod_name)
            uuid = view["env"]["CUDA_VISIBLE_DEVICES"]
            if uuid != uuid_of[dev]:
                fail(f"demo {a.name}: {pod_name} allocated {dev} "
                     f"({uuid_of[dev]}), CUDA_VISIBLE_DEVICES {uuid}")
            return claim, dev, uuid, a.finish(a.start(pod, view), claim,
                                              uuid)

        # tpu-test1: on one card the second pod's claim is refused until
        # the first pod is gone, then gets the same card
        a = Applied("tpu-test1")
        c1, dev1, uuid1, _ = run_alone(a, "pod1")
        c2 = a.of_pod["pod2"]
        refused = None
        if len(cuda) == 1:
            try:
                a.schedule(c2)
            except AllocationError as e:
                refused = str(e)
            if refused is None:
                fail("demo tpu-test1: pod2's claim was allocated while "
                     "pod1 held the one card")
        a.delete(c1)
        _, dev2, uuid2, _ = run_alone(a, "pod2")
        if len(cuda) == 1 and (dev2, uuid2) != (dev1, uuid1):
            fail(f"demo tpu-test1: pod2 got {dev2} after pod1's {dev1}")
        a.delete(c2)
        line("tpu-test1", f"pod1 on {dev1}; pod2 refused while pod1 held "
             f"it ({refused}); after pod1's unprepare pod2 on {dev2}, the "
             f"same card: {dev2 == dev1}")

        # tpu-test2: one claim, two containers of one pod at once
        a = Applied("tpu-test2")
        (pod,) = a.pods
        claim = a.of_pod["pod"]
        dev = a.schedule(claim)
        view = a.prepare(claim)
        uuid = uuid_of[dev]
        outs = a.finish(a.start(pod, view), claim, uuid)
        for key in ("ctr0", "ctr1"):
            if not outs[key].splitlines()[0].endswith("preemption = 20"):
                fail(f"demo tpu-test2: {key}: {outs[key]}")
        a.delete(claim)

        # tpu-test3 and the coordinated specs: pods sharing one claim run
        # at once and see the same card
        for name in ("tpu-test3", "tpu-test-coordinator",
                     "tpu-test-enforced"):
            a = Applied(name)
            (claim,) = a.claims.values()
            dev = a.schedule(claim)
            uuid = uuid_of[dev]
            # the kubelet prepares the claim for each pod that uses it
            views = [a.prepare(claim) for _ in a.pods]
            started = [p for pod, view in zip(a.pods, views)
                       for p in a.start(pod, view)]
            # the gated pods' registrations: the workers of the
            # coordinator's published schedule while they run
            cdir = (Path(coordination_env(views[0])["TPU_COORDINATOR_DIR"])
                    if name == "tpu-test-enforced" else None)
            slots = set()
            while cdir is not None and any(
                    p.proc.poll() is None for p in started):
                try:
                    published = json.loads(
                        (cdir / "schedule.json").read_text())
                    slots |= {s["worker"] for s in published["slots"]}
                except (FileNotFoundError, json.JSONDecodeError):
                    pass
                time.sleep(0.05)
            outs = a.finish(started, claim, uuid)
            spans = [(p.start_at, p.end_at) for p in started]
            if min(e for _, e in spans) <= max(s for s, _ in spans):
                fail(f"demo {name}: the pods did not run at once: {spans}")
            if name == "tpu-test-coordinator":
                for key, text in outs.items():
                    if " duty = 50 dir = " not in text.splitlines()[0]:
                        fail(f"demo {name}: {key}: {text}")
                if len(pods.procs) != 1:
                    fail(f"demo {name}: coordinator daemons "
                         f"{list(pods.procs)}")
            if name == "tpu-test-enforced":
                ticks = {k: int(t.split("ticks=")[1].split()[0])
                         for k, t in outs.items()}
                if slots != {"pod1", "pod2"} or min(ticks.values()) <= 0:
                    fail(f"demo {name}: schedule slots {slots}, ticks "
                         f"{ticks}")
                line(name, f"the gate's schedule listed {sorted(slots)}; "
                     f"ticks {ticks}")
            a.delete(claim)

        # tpu-test5: two requests need two cards
        a = Applied("tpu-test5")
        claim = a.of_pod["pod"]
        if len(cuda) == 1:
            try:
                allocate_claim(cluster, claim)
            except AllocationError as e:
                line("tpu-test5", f"refused on the one-card node, as the "
                     f"spec says (two requests, one card): {e}")
            else:
                fail("demo tpu-test5: two requests allocated on one card")
            cluster.delete("ResourceClaim", claim.metadata.namespace,
                           claim.metadata.name)
        else:
            fail(f"demo tpu-test5: this phase runs on one card, not "
                 f"{len(cuda)}")

        # tpu-test6: the CEL selector on the H100's attributes
        a = Applied("tpu-test6")
        claim, dev, uuid, _ = run_alone(a, "pod")
        a.delete(claim)

        # tpu-test-serve: the probes on the claimed card
        a = Applied("tpu-test-serve")
        claim, dev, uuid, outs = run_alone(a, "serve-pod")
        res = json.loads(outs["serve-pod"].split("serve result:", 1)[1]
                         .splitlines()[0])
        r, s = res["decode"], res["serving"]
        if not (r["valid"] and s["valid"] and res["flash_fwd_tc"] > 0
                and res["flash_fwd"] == res["flash_fwd_tc"]):
            fail(f"demo tpu-test-serve: {res}")
        # the pod's K1 shapes are the ones phase_flash holds to the plain
        # version and the oracle
        sv = DEMO_SERVE_K1
        ran = (r["batch"], r["prompt_len"], r["heads"], r["kv_heads"],
               r["d_model"] // r["heads"], s["slots"])
        if ran != (sv["b"], sv["ts"][0], sv["h"], sv["h_kv"], sv["d"],
                   sv["b"]):
            fail(f"demo tpu-test-serve: the pod ran (batch, prompt, heads, "
                 f"kv heads, head dim, slots) {ran}; phase_flash holds K1 "
                 f"at {sv}")
        a.delete(claim)
        out["launches"] = {k: res[k] for k in ("flash_fwd", "flash_fwd_tc")}
        out["serve"] = dict(decode_tokens_per_s=r["tokens_per_s"],
                            decode_ms_per_token=r["ms_per_token"],
                            serving_tokens_per_s=s["tokens_per_s_lower_bound"])
        line("tpu-test-serve", f"on {dev}: decode_probe {r['tokens_per_s']:.1f}"
             f" tokens/s ({r['ms_per_token']:.4f} ms/token, {r['params_m']}M "
             f"params, bf16, valid), serving_probe "
             f"{s['tokens_per_s_lower_bound']:.1f} tokens/s lower bound over "
             f"{s['requests']} requests on {s['slots']} slots (valid); K1 "
             f"launches {out['launches']}, all on the tensor-core route")
    finally:
        for p in children:
            if p.proc.poll() is None:
                p.proc.kill()
                p.proc.wait()
        if plugin is not None:
            plugin_stop(*plugin)
        pods.stop_all()
        root_log = logging.getLogger()
        root_log.handlers[:] = saved_log[0]
        root_log.setLevel(saved_log[1])
        shutil.rmtree(tmp, ignore_errors=True)
    if pods.errors:
        fail(f"demo: coordinator pods {pods.errors}")
    lat = sorted(out["latency_ms"].values())
    out["p50_ms"] = float(np.median(lat))
    out["wall_s"] = time.perf_counter() - t0
    print(f"demo [{card}]: phase wall {out['wall_s']:.2f} s; claim created "
          f"-> first line of the container, per pod (ms, host clock, a "
          f"reading): "
          + ", ".join(f"{k} {v:.1f}" for k, v in out["latency_ms"].items())
          + f"; p50 {out['p50_ms']:.1f} ms over {len(lat)} containers; serve "
          f"pod {out['serve']['decode_tokens_per_s']:.1f} tokens/s decode, "
          f"{out['serve']['serving_tokens_per_s']:.1f} tokens/s serving; K1 "
          f"launches {out['launches']}", flush=True)
    return out


def sdpa_fn(q, k, v, causal):
    """One PyTorch call computing the same attention (yardstick only,
    never called by the port)."""
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    group = q.shape[2] // k.shape[2]
    if "enable_gqa" in (F.scaled_dot_product_attention.__doc__ or ""):
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=group > 1)
    kt = kt.repeat_interleave(group, dim=1)
    vt = vt.repeat_interleave(group, dim=1)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal)


def flash_bound(b, t, h, h_kv, d, window, seg, dtype) -> tuple[float, str]:
    """Least time for one forward: inputs read once, outputs written
    once, over the memory rate; the valid (q, k) pairs' 4*D flops over
    the peak rate of the inputs' type; the larger of the two."""
    es = torch.tensor([], dtype=dtype).element_size()
    nbytes = (b * t * (2 * h + 2 * h_kv) * d * es + b * h * t * 4
              + (b * t * 4 if seg is not None else 0))
    qpos = np.arange(t)[:, None]
    kpos = np.arange(t)[None]
    valid = kpos <= qpos
    if window:
        valid &= qpos - kpos < window
    pairs = 0
    if seg is not None:
        for row in seg.cpu().numpy():
            pairs += int((valid & (row[:, None] == row[None])).sum())
        pairs *= h
    else:
        pairs = b * h * int(valid.sum())
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
    t_b, t_f = nbytes / H100_BYTES_PER_S, 4 * d * pairs / peak
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def phase_flash(fa) -> dict:
    """K1 against its plain version; returns the kernels-line row at
    the largest prefill call of the s8_r24 contiguous drain (B=2
    T=96), and, by shape, callables of the kernel, its plain version
    and the library call at that shape and at B=8 T=2048.

    bf16 runs on the tensor-core route: its f32 output (``out_dtype``
    float32, before the final rounding) is held to
    ``flash_forward_reference`` at FWD_TC_TOL, its bf16 output must be
    that output rounded, bit for bit, and the f32 oracle
    ``attention_forward`` within TOL[bf16].  f32 runs on the CUDA-core
    route, held to the plain version at TOL[f32]."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = []
    for b in (1, 2, 8):
        for t in (24, 48, 72, 96, 2048):
            if b == 2 and t == 2048:
                continue
            cases.append(dict(b=b, t=t, d=64, window=None, seg=False,
                              dtype=torch.bfloat16))
    cases += [
        dict(b=8, t=2048, d=64, window=256, seg=False,
             dtype=torch.bfloat16),
        dict(b=8, t=96, d=64, window=None, seg=True, dtype=torch.bfloat16),
        dict(b=2, t=2048, d=64, window=256, seg=True,
             dtype=torch.bfloat16),
        dict(b=2, t=96, d=128, window=None, seg=False,
             dtype=torch.bfloat16),
        dict(b=2, t=2048, d=128, window=None, seg=False,
             dtype=torch.bfloat16),
        dict(b=1, t=300, d=128, window=64, seg=True, dtype=torch.bfloat16),
        dict(b=1, t=96, d=64, window=None, seg=True, dtype=torch.float32),
        dict(b=1, t=2048, d=128, window=32, seg=False,
             dtype=torch.float32),
    ]
    # the small head dims in both dtypes: a causal prefill, a long
    # windowed one with segments, MHA once; then the spec probe's
    # prompt fill (4 prompts of 40 tokens, 8 heads of 16 over 4), the
    # kernels-line row of the small dims
    for d in SMALL_DIMS:
        for dtype in (torch.bfloat16, torch.float32):
            cases += [
                dict(b=2, t=96, d=d, window=None, seg=False, dtype=dtype,
                     h=8, h_kv=4),
                dict(b=1, t=300, d=d, window=64, seg=True, dtype=dtype,
                     h=4, h_kv=2),
                dict(b=2, t=128, d=d, window=None, seg=False, dtype=dtype,
                     h=8, h_kv=8)]
    cases.append(dict(b=4, t=40, d=16, window=None, seg=False,
                      dtype=torch.bfloat16, h=8, h_kv=4,
                      probe="the spec probe's prompt fill"))
    # the demo serve pod's prefills
    sv = DEMO_SERVE_K1
    cases += [dict(b=sv["b"], t=t, d=sv["d"], window=None, seg=False,
                   dtype=torch.bfloat16, h=sv["h"], h_kv=sv["h_kv"])
              for t in sv["ts"]]
    # the multichip phase's prefills: the 154M's at tp=2 on one rank's
    # heads in both dtypes ((b)'s prefill, (e)'s engine fills: the
    # kernels line's tp_rank rows of K1), moe_heavy's at tp=2 in f32,
    # the flagship forward's, the dryrun decode's
    both = (torch.bfloat16, torch.float32)
    for shape, dtypes, tp_row in (
            *((x, both, True) for x in [TP_PREFILL_K1, *TP_ENGINE_K1]),
            (TP_MOE_PREFILL_K1, (torch.float32,), False),
            (ENTRY_K1, (torch.bfloat16,), False),
            (DRYRUN_DECODE_K1, (torch.float32,), False)):
        cases += [dict(b=shape["b"], t=shape["t"], d=shape["d"],
                       window=None, seg=False, dtype=dtype, h=shape["h"],
                       h_kv=shape["h_kv"], tp_rank=tp_row)
                  for dtype in dtypes]
    row, probes = None, {}
    for c in cases:
        b, t, d, dtype = c["b"], c["t"], c["d"], c["dtype"]
        tc = dtype == torch.bfloat16
        h, h_kv = c.get("h", 16), c.get("h_kv", 4)
        q = torch.randn((b, t, h, d), generator=gen, device=dev,
                        dtype=torch.float32).to(dtype)
        k = torch.randn((b, t, h_kv, d), generator=gen, device=dev,
                        dtype=torch.float32).to(dtype)
        v = torch.randn((b, t, h_kv, d), generator=gen, device=dev,
                        dtype=torch.float32).to(dtype)
        seg = None
        if c["seg"]:
            cuts = torch.randint(0, 4, (b, t), generator=gen, device=dev)
            seg = (torch.cumsum((cuts == 0).to(torch.int32), dim=1)
                   .to(torch.int32).contiguous())
        kw = dict(causal=True, window=c["window"], segment_ids=seg)
        before = fa.tc_launches
        out, lse = fa.flash_forward(q, k, v, **kw)
        if fa.tc_launches != before + tc:
            fail(f"K1 took the wrong route at {c}")
        ref, ref_lse = fa.flash_forward_reference(
            q, k, v, out_dtype=torch.float32, **kw)
        torch.cuda.synchronize()
        if not torch.isfinite(out.float()).all():
            fail(f"K1 non-finite output at {c}")
        scale = max(1.0, ref.abs().max().item())
        lerr = (lse - ref_lse).abs().max().item()
        if tc:
            full, full_lse = fa.flash_forward(q, k, v,
                                              out_dtype=torch.float32, **kw)
            err = (full - ref).abs().max().item()
            rounded = (torch.equal(out, full.to(dtype))
                       and torch.equal(lse, full_lse))
            oracle = fa.attention_forward(q, k, v, **kw)[0]
            oerr = (out.float() - oracle.float()).abs().max().item()
            ok = (err <= FWD_TC_TOL * scale and rounded
                  and oerr <= TOL[dtype] and lerr <= LSE_TOL)
            held = (f"f32 output max|d|={err:.3g} (tol {FWD_TC_TOL} x "
                    f"max(1, max|plain| {scale:.3g})), bf16 output the f32 "
                    f"one rounded: {rounded}; oracle max|d|={oerr:.3g} "
                    f"(tol {TOL[dtype]})")
        else:
            err = (out - ref).abs().max().item()
            ok = err <= TOL[dtype] and lerr <= LSE_TOL
            held = f"max|d|={err:.3g} (tol {TOL[dtype]})"
        ms = cuda_ms(lambda: fa.flash_forward(q, k, v, **kw))
        plain_ms = cuda_ms(lambda: fa.flash_forward_reference(q, k, v,
                                                              **kw),
                           iters=5)
        lib_ms = None
        if seg is None and c["window"] is None:
            lib_ms = cuda_ms(sdpa_fn(q, k, v, True))
        bound, by = flash_bound(b, t, h, h_kv, d, c["window"], seg,
                                dtype)
        plan = fa.pick_fwd_params(t, t, d, h // h_kv, c["window"], dtype)
        print(f"K1 B={b} T={t} H={h} Hkv={h_kv} D={d} "
              f"window={c['window']} seg={seg is not None} "
              f"{str(dtype).removeprefix('torch.')} "
              f"({'tensor cores' if tc else 'CUDA cores'}; plan "
              f"block_q={plan['block_q']} block_k={plan['block_k']}): "
              f"{held} lse "
              f"max|d|={lerr:.3g} (tol {LSE_TOL}) kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms={fmt(lib_ms)} "
              f"bound_us={bound * 1e3:.2f} ({by}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"K1 disagrees with its plain version at {c}")
        plain_causal = (seg is None and c["window"] is None and tc)
        if plain_causal and (b, t, d) in ((2, 96, 64), (8, 2048, 64),
                                          (2, 2048, 128)):
            main = " (main path)" if (b, t) == (2, 96) else ""
            probes[f"B={b} T={t} D={d}{main}"] = dict(
                kernel=lambda q=q, k=k, v=v: fa.flash_forward(q, k, v),
                plain=lambda q=q, k=k, v=v: fa.flash_forward_reference(
                    q, k, v),
                library=sdpa_fn(q, k, v, True))
        if plain_causal and (b, t, d) == (2, 96, 64):
            row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound, bound_by=by, library_ms=lib_ms)
        if c.get("tp_rank"):
            runs = ("multichip (b)'s prefill and (e)'s engine fills"
                    if (b, t) == (TP_PREFILL_K1["b"], TP_PREFILL_K1["t"])
                    else "multichip (e)'s engine fills")
            TP_RANK_ROWS["K1"].append(dict(
                shape=f"B={b} T={t} H={h} Hkv={h_kv} D={d} causal "
                f"{str(dtype).removeprefix('torch.')} (one tp=2 rank of "
                f"the 154M, {runs})",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=lib_ms, plan=plan))
        if "probe" in c:
            SMALL_D_ROWS["K1"] = dict(
                shape=f"B={b} T={t} H={h} Hkv={h_kv} D={d} causal bf16 "
                f"({c['probe']})", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=lib_ms)
    return row, probes


#: K1's block entry against its plain version, relative to max(1,
#: max|plain|) on o and l (m absolute): bf16 as the normalized entry
#: (FWD_TC_TOL: the plain version sums its scores on the tensor cores in
#: the kernel's order), f32 as TOL[f32]; rows the plain version leaves
#: empty must be m = -1e30, l = 0, o = 0 exactly
BLOCK_TOL = {torch.bfloat16: FWD_TC_TOL, torch.float32: TOL[torch.float32]}
#: the ring's hop shape at the 154M over sp=2 (B=8, T/2 = 1024 rows)
HOP_B, HOP_T = 8, 1024


def block_bound(b, tq, tk, h, h_kv, d, pairs, dtype) -> tuple[float, str]:
    """Least time of one block-entry call: q, k, v read once and o, m, l
    (f32) written once over the memory rate; 4*D flops per valid pair
    over the peak rate of the inputs' type."""
    es = torch.tensor([], dtype=dtype).element_size()
    nbytes = (b * (tq * h + 2 * tk * h_kv) * d * es
              + b * tq * h * (d + 2) * 4)
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
    t_b, t_f = nbytes / H100_BYTES_PER_S, 4 * d * pairs / peak
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def block_pairs(b, tq, tk, h, q_off, k_off, causal, window, qs, ks) -> int:
    """Valid (query, key) pairs of one block call on these inputs."""
    qpos = q_off + np.arange(tq)[:, None]
    kpos = k_off + np.arange(tk)[None]
    valid = np.ones((tq, tk), bool)
    if causal:
        valid &= kpos <= qpos
        if window:
            valid &= qpos - kpos < window
    if qs is None:
        return b * h * int(valid.sum())
    return h * sum(int((valid & (a[:, None] == c[None])).sum())
                   for a, c in zip(qs.cpu().numpy(), ks.cpu().numpy()))


def check_block(fa, q, k, v, q_off, k_off, label, causal=True, window=None,
                qs=None, ks=None) -> float:
    """One block-entry call against its plain version; fails the run on
    a disagreement or a wrong route.  Returns max|d| of o."""
    tc = q.dtype == torch.bfloat16
    kw = dict(causal=causal, window=window, q_segments=qs, k_segments=ks)
    before = (fa.block_launches, fa.block_tc_launches, fa.launches)
    o, m, l = fa.flash_block_attention(q, k, v, q_off, k_off, **kw)
    after = (fa.block_launches, fa.block_tc_launches, fa.launches)
    if after != (before[0] + 1, before[1] + tc, before[2]):
        fail(f"K1 block {label}: launch counts {before} -> {after}")
    ro, rm, rl = fa.flash_block_attention_reference(q, k, v, q_off, k_off,
                                                    **kw)
    torch.cuda.synchronize()
    dead = rl == 0
    dead_ok = (torch.equal(l == 0, dead) and bool((m[dead] == -1e30).all())
               and bool((o.transpose(1, 2)[dead] == 0).all()))
    scale = max(1.0, ro.abs().max().item())
    err = (o - ro).abs().max().item()
    lerr = (l - rl).abs().max().item() / max(1.0, rl.abs().max().item())
    merr = (m - rm)[~dead].abs().max().item() if (~dead).any() else 0.0
    tol = BLOCK_TOL[q.dtype]
    finite = all(bool(torch.isfinite(x).all()) for x in (o, m, l))
    ok = (finite and dead_ok and err <= tol * scale and lerr <= tol
          and merr <= tol)
    b, tq, h, d = q.shape
    print(f"K1 block {label}: B={b} Tq={tq} Tk={k.shape[1]} H={h} "
          f"Hkv={k.shape[2]} D={d} offsets ({q_off}, {k_off}) "
          f"window={window} seg={qs is not None} "
          f"{str(q.dtype).removeprefix('torch.')} "
          f"({'tensor cores' if tc else 'CUDA cores'}): o max|d|={err:.3g} "
          f"(tol {tol} x max(1, max|plain| {scale:.3g})), l rel "
          f"{lerr:.3g}, m max|d|={merr:.3g}; empty rows "
          f"{int(dead.sum())} exactly (m=-1e30, l=0, o=0): {dead_ok} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"K1 block entry disagrees with its plain version at {label}")
    return err


def phase_flash_block(fa) -> tuple[dict, dict]:
    """K1's block entry (``flash_block_attention``) on both routes,
    D = 64, 128 and SMALL_DIMS, GQA 16/4, against
    ``flash_block_attention_reference``
    at the offset pairs of a ring: the full block, the diagonal, a block
    wholly above it (every row empty), a window crossing the block,
    Tq != Tk (192 x 320), distinct q/k segments.  Then S = 4 hops of one
    sequence merged with ``merge_flash_stats`` and normalized, against
    the normalized K1 (f32 output) within TOL[dtype].  Then times at the
    ring's hop shape (B=8 Tq=Tk=1024 H=16 Hkv=4 D=64 bf16), diagonal and
    full, beside their bounds, the plain version and SDPA (timed only).
    Returns the kernels-line row (the diagonal hop) and the probes."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    h, h_kv = 16, 4

    def rand(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(dtype)

    def segs(b, n):
        cuts = torch.randint(0, 40, (b, n), generator=gen, device=dev)
        return torch.cumsum((cuts == 0).to(torch.int32), dim=1).to(
            torch.int32)

    for dtype in (torch.bfloat16, torch.float32):
        for d in (64, 128) + SMALL_DIMS:
            t = 256
            q = rand(2, t, h, d, dtype=dtype)
            k, v = rand(2, t, h_kv, d, dtype=dtype), rand(2, t, h_kv, d,
                                                           dtype=dtype)
            for label, qo, ko, window in (("full", t, 0, None),
                                          ("diagonal", 0, 0, None),
                                          ("above the diagonal", 0, t, None),
                                          ("window crossing", t // 2, 0,
                                           100)):
                check_block(fa, q, k, v, qo, ko, label, window=window)
            q2 = rand(2, 192, h, d, dtype=dtype)
            k2, v2 = rand(2, 320, h_kv, d, dtype=dtype), rand(
                2, 320, h_kv, d, dtype=dtype)
            check_block(fa, q2, k2, v2, 300, 100, "Tq != Tk")
            ids = segs(2, 420)
            check_block(fa, q2, k2, v2, 228, 100, "q/k segments",
                        qs=ids[:, 228:].contiguous(),
                        ks=ids[:, 100:420].contiguous())
            check_block(fa, q2, k2, v2, 0, 0, "non-causal segments",
                        causal=False, qs=ids[:, :192].contiguous(),
                        ks=ids[:, 100:420].contiguous())

        # S hops of one sequence, merged, against the normalized K1
        t, s = 1024, 4
        q = rand(2, t, h, 64, dtype=dtype)
        k, v = rand(2, t, h_kv, 64, dtype=dtype), rand(2, t, h_kv, 64,
                                                       dtype=dtype)
        want = fa.flash_forward(q, k, v, out_dtype=torch.float32)[0]
        tl = t // s
        got = []
        for qi in range(s):
            acc = None
            for ki in range(s):
                stats = fa.flash_block_attention(
                    q[:, qi * tl:(qi + 1) * tl].contiguous(),
                    k[:, ki * tl:(ki + 1) * tl].contiguous(),
                    v[:, ki * tl:(ki + 1) * tl].contiguous(), qi * tl,
                    ki * tl)
                acc = stats if acc is None else fa.merge_flash_stats(*acc,
                                                                     *stats)
            got.append(fa.normalize_flash_stats(*acc)[0])
        merr = (torch.cat(got, dim=1) - want).abs().max().item()
        print(f"K1 block: {s} hops of B=2 T={t} merged and normalized vs "
              f"the normalized K1 ({str(dtype).removeprefix('torch.')}, "
              f"f32 output): max|d|={merr:.3g} (tol {TOL[dtype]}) "
              f"{'ok' if merr <= TOL[dtype] else 'FAIL'}", flush=True)
        if merr > TOL[dtype]:
            fail("merged block-entry hops disagree with the normalized K1")

    # the ring's hop shape at the 154M, sp=2
    q = rand(HOP_B, HOP_T, h, 64, dtype=torch.bfloat16)
    k = rand(HOP_B, HOP_T, h_kv, 64, dtype=torch.bfloat16)
    v = rand(HOP_B, HOP_T, h_kv, 64, dtype=torch.bfloat16)
    row, probes = None, {}
    for label, qo, causal in (("diagonal", 0, True), ("full", HOP_T, True)):
        err = check_block(fa, q, k, v, qo, 0, f"hop {label}")
        pairs = block_pairs(HOP_B, HOP_T, HOP_T, h, qo, 0, causal, None,
                            None, None)
        bound, by = block_bound(HOP_B, HOP_T, HOP_T, h, h_kv, 64, pairs,
                                torch.bfloat16)
        kernel = (lambda qo=qo: fa.flash_block_attention(q, k, v, qo, 0))
        plain = (lambda qo=qo: fa.flash_block_attention_reference(
            q, k, v, qo, 0))
        # SDPA of the same pairs: the diagonal is a causal square, the
        # full hop an unmasked one (yardstick only)
        library = sdpa_fn(q, k, v, label == "diagonal")
        ms = cuda_ms(kernel)
        plain_ms = cuda_ms(plain, iters=3)
        lib_ms = cuda_ms(library)
        print(f"K1 block hop {label} B={HOP_B} Tq=Tk={HOP_T} H={h} "
              f"Hkv={h_kv} D=64 bf16: kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} sdpa_ms={lib_ms:.4f} "
              f"bound_us={bound * 1e3:.2f} ({by}; {pairs} pairs, "
              f"{4 * 64 * pairs / 1e9:.1f} GFLOP)", flush=True)
        main = " (main path)" if label == "diagonal" else ""
        probes[f"hop {label} B={HOP_B} Tq=Tk={HOP_T}{main}"] = dict(
            kernel=kernel, plain=plain, library=library)
        if label == "diagonal":
            row = dict(max_abs_err=err, ms=ms,
                       plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                       library_ms=lib_ms)
    return row, probes


def paged_bound(lengths, b, h, h_kv, d, es) -> tuple[float, str]:
    """Least time for one paged step: the valid K/V rows plus q, out,
    tables and lengths over the memory rate, against 4*D flops per
    (head, valid key) over the bf16 peak."""
    kv_bytes = 2 * int(sum(lengths)) * h_kv * d * es
    nbytes = kv_bytes + 2 * b * h * d * es + 8 * b
    flops = 4 * d * h * int(sum(lengths))
    t_b, t_f = nbytes / H100_BYTES_PER_S, flops / H100_BF16_FLOPS
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def paged_cases(pa) -> list:
    """K2's cases: (label, lengths, head dim, dtype).  The first five
    are the bring-up's; then the split kernel's own: one 2048-token row
    (many splits), eight rows of one key, rows ending exactly on and
    next to a span's end (the next span empty or one key long), and
    D=128 at eight 2048-token rows."""
    bf16, f32 = torch.bfloat16, torch.float32
    span = pa.paged_plan(8, 4, 4, 64, 16, 2048 // 16, bf16).pages_per_split * 16
    return [
        ("mixed", [1, 17, 96, 2048, 1, 17, 96, 2048], 64, bf16),
        ("main", [120, 72, 96, 48, 120, 72, 96, 48], 64, bf16),
        ("long", [2048] * 8, 64, bf16),
        ("mixed D=128", [1, 17, 96, 2048, 5, 33, 300, 1000], 128, bf16),
        ("mixed f32", [1, 17, 96, 2048, 5, 33, 300, 1000], 64, f32),
        ("one row", [2048], 64, bf16),
        ("one key", [1] * 8, 64, bf16),
        ("span ends", [span, 2 * span, span - 1, span + 1, 3 * span,
                       2048, 16, span * (2048 // span)], 64, bf16),
        ("long D=128", [2048] * 8, 128, bf16),
    ]


def paged_small_cases() -> list:
    """K2 at the small head dims: (label, lengths, head dim, dtype,
    query heads, KV heads).  Each D in SMALL_DIMS, both dtypes, groups
    of 1, 2 and 4 query heads a KV head (every block width the kernel
    has), on rows of one key to 2048 (several splits); then the paged-KV
    probe's decode step (6 rows of 21-26 keys, 8 heads of 16 over 4,
    f32), the kernels-line row of the small dims."""
    mixed = [1, 17, 96, 2048, 5, 33, 300, 1000]
    cases = [(f"D={d} group {g}", mixed, d, dtype, 4 * g, 4)
             for d in SMALL_DIMS
             for dtype in (torch.bfloat16, torch.float32)
             for g in (1, 2, 4)]
    cases.append(("paged-KV probe step", [21, 22, 23, 24, 25, 26], 16,
                  torch.float32, 8, 4))
    return cases


def paged_tp_cases() -> list:
    """K2 at one tp=2 rank of the 154M (8 of 16 query and 2 of 4 KV
    heads, D=64, blocks of 16) in both dtypes, on the tables each of
    phase_multichip's paged runs builds, so that each plan is one a run
    launches: (b)'s paged variant at its mid-run step (8 rows of 112
    keys: 96 prompt tokens + 16 steps) on tables of
    (MULTICHIP_PROMPT_LEN + MULTICHIP_NEW) // MULTICHIP_BS pages, and
    (e)'s paged engine (8 slots, its default blocks of MULTICHIP_BS) at
    a mid-drain step of s8_r24 (lengths 120/72/96/48) on its tables of
    max_seq // MULTICHIP_BS pages: (label, lengths, head dim, dtype,
    query heads, KV heads, table width)."""
    width = (MULTICHIP_PROMPT_LEN + MULTICHIP_NEW) // MULTICHIP_BS
    engine = serving_config().max_seq // MULTICHIP_BS
    return [(f"tp=2 {run} {str(dtype).removeprefix('torch.')}", lengths,
             64, dtype, 8, 2, pages)
            for run, lengths, pages in (
                ("rank", [112] * 8, width),
                ("engine", [120, 72, 96, 48, 120, 72, 96, 48], engine))
            for dtype in (torch.bfloat16, torch.float32)]


def k2_direct(pa, args, plan) -> torch.Tensor:
    """K2 launched through its C entry on a given plan (outside the
    wrapper and its count): the main path's step on one split, so the
    grid holds no dead blocks, to measure what the dead blocks cost."""
    from k8s_dra_driver_tpu_torch.ops import _build
    q, k_pool, v_pool, tables, lens = args
    b, h, d = q.shape
    _, bs, h_kv, _ = k_pool.shape
    if plan.splits != 1:
        raise ValueError("k2_direct takes one-split plans")
    out = torch.empty_like(q)
    rc = _build.library().paged_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        tables.data_ptr(), lens.data_ptr(), out.data_ptr(), None, None,
        b, h, h_kv, d, bs, tables.shape[1], plan.heads_per_block,
        plan.pages_per_split, 1, d ** -0.5,
        _build.DTYPE_CODES[str(q.dtype).removeprefix("torch.")],
        torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "paged_decode")
    return out


def phase_paged(pa) -> tuple[dict, dict]:
    """K2 against its plain version at :func:`paged_cases` (tables of
    128 pages) and :func:`paged_tp_cases` (the width (b) builds), the
    plan each launch takes printed, on pools whose null block is NaN
    (the kernel must never read a tail entry's page); a bitwise repeat
    of every case; the run fails unless some row spanned several splits
    (the merge ran) and every arrival counter is back at 0.  Returns the kernels-line row at a mid-drain
    decode step of the s8_r24 paged engine (lengths 120/72/96/48), and,
    by shape, callables of the kernel and its plain version at that
    step, at eight and at one 2048-token rows, of the kernel on a
    one-split grid at the step (no dead blocks), and of one empty
    launch (what a separate merge kernel would add at least)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    rng = np.random.default_rng(2)
    bs = 16
    wide = 2048 // bs
    row, probes, multi = None, {}, 0
    cases = ([(*c, 16, 4, wide) for c in paged_cases(pa)]
             + [(*c, wide) for c in paged_small_cases()] + paged_tp_cases())
    for label, lengths, d, dtype, h, h_kv, n_pages in cases:
        b = len(lengths)
        n_blocks = b * n_pages + 1
        k_pool = torch.randn((n_blocks, bs, h_kv, d), generator=gen,
                             device=dev).to(dtype)
        v_pool = torch.randn((n_blocks, bs, h_kv, d), generator=gen,
                             device=dev).to(dtype)
        q = torch.randn((b, h, d), generator=gen, device=dev).to(dtype)
        # shuffled, non-contiguous block tables; unused slots -> null 0
        perm = rng.permutation(np.arange(1, n_blocks))
        tables = np.zeros((b, n_pages), np.int32)
        for i, length in enumerate(lengths):
            need = -(-length // bs)
            tables[i, :need] = perm[i * n_pages:i * n_pages + need]
        tables = torch.as_tensor(tables, device=dev)
        lens = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
        # the kernel reads pools whose null block 0 is NaN, so reading a
        # tail entry's page would show; the plain version gathers every
        # table slot and reads copies whose null block is 0 (its masked
        # keys add exact zeros either way)
        clean = [x.clone() for x in (k_pool, v_pool)]
        for x, c in zip((k_pool, v_pool), clean):
            x[0], c[0] = float("nan"), 0.0
        args = (q, k_pool, v_pool, tables, lens)
        ref_args = (q, *clean, tables, lens)
        plan = pa.PagedPlan(**pa.pick_decode_params(
            b, h_kv, h // h_kv, d, bs, n_pages, dtype))
        span = plan.pages_per_split * bs
        live = [-(-min(n, n_pages * bs) // span) for n in lengths]
        multi += sum(n > 1 for n in live)
        out = pa.paged_attention(*args)
        again = pa.paged_attention(*args)
        ref = pa.paged_attention_reference(*ref_args)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        same = torch.equal(out, again)
        ms = cuda_ms(lambda: pa.paged_attention(*args))
        plain_ms = cuda_ms(lambda: pa.paged_attention_reference(*ref_args),
                           iters=5)
        es = torch.tensor([], dtype=dtype).element_size()
        bound, by = paged_bound(lengths, b, h, h_kv, d, es)
        ok = (bool(torch.isfinite(out.float()).all()) and err <= TOL[dtype]
              and same)
        print(f"K2 {label}: B={b} H={h} Hkv={h_kv} D={d} bs={bs} "
              f"tables of {n_pages} pages "
              f"lengths={lengths} {str(dtype).removeprefix('torch.')}: "
              f"plan heads_per_block={plan.heads_per_block} "
              f"pages_per_split={plan.pages_per_split} "
              f"splits={plan.splits} blocks={plan.blocks} live splits "
              f"per row={live}: max|d|={err:.3g} (tol {TOL[dtype]}) "
              f"repeat {'bitwise equal' if same else 'DIFFERS'} "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms=None bound_us={bound * 1e3:.2f} ({by}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"K2 disagrees with its plain version or its repeat at "
                 f"{label} {lengths}")
        if label in ("main", "long", "one row", "long D=128"):
            main = " (main path)" if label == "main" else ""
            probes[f"{label} {lengths[:4]}{main}"] = dict(
                kernel=lambda a=args: pa.paged_attention(*a),
                plain=lambda a=ref_args: pa.paged_attention_reference(*a))
        if label == "main":
            whole = plan._replace(pages_per_split=n_pages, splits=1,
                                  blocks=plan.blocks // plan.splits)
            direct = k2_direct(pa, args, whole)
            torch.cuda.synchronize()
            if not torch.equal(direct, out):
                fail("K2 on a one-split grid differs from the planned "
                     "grid at the main path's step")
            probes[f"{label} on one split, {whole.blocks} blocks"] = dict(
                kernel=lambda a=args, p=whole: k2_direct(pa, a, p))
            # the least a separate merge kernel would add to every call:
            # one launch that does nothing
            probes["one more launch (an empty kernel)"] = dict(
                kernel=lambda: torch.cuda._sleep(0))
            row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound, bound_by=by, library_ms=None,
                       plan=plan._asdict())
        if label.startswith("tp=2 "):
            run = ("multichip (b)" if label.startswith("tp=2 rank")
                   else "multichip (e)'s paged engine")
            TP_RANK_ROWS["K2"].append(dict(
                shape=f"B={b} H={h} Hkv={h_kv} D={d} bs={bs} tables of "
                f"{n_pages} pages, lengths {lengths} "
                f"{str(dtype).removeprefix('torch.')} (one tp=2 rank of "
                f"the 154M, {run})",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=None, plan=plan._asdict()))
        if label == "paged-KV probe step":
            SMALL_D_ROWS["K2"] = dict(
                shape=f"B={b} H={h} Hkv={h_kv} D={d} bs={bs} lengths "
                f"{lengths} f32 (the paged-KV probe's decode step)",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=None, plan=plan._asdict())
    if not multi:
        fail("no K2 case spanned several splits: the merge never ran")
    busy = [int(c.count_nonzero()) for _, c in pa._buffers.values()]
    if not busy or any(busy):
        fail(f"K2's arrival counters are not all back at 0: {busy}")
    print(f"K2: {multi} rows over several splits, merged in split order; "
          f"every arrival counter back at 0", flush=True)
    return row, probes


def block_forward(fa, q, k, v, q_off, k_off, window, k_valid_end, seg_q,
                  seg_k):
    """(out, lse) of one K/V block in plain f32, lse over that block:
    what a forward over the same block hands the backward."""
    mask = fa.block_mask(q.shape[1], k.shape[1], q_off, k_off, True,
                         window, k_valid_end, seg_q, seg_k, q.device)
    group = q.shape[2] // k.shape[2]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     k.float().repeat_interleave(group, dim=2))
    s = (s * q.shape[-1] ** -0.5).masked_fill(~mask[:, None], -1e30)
    lse = torch.logsumexp(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.exp(s - lse[..., None]),
                       v.float().repeat_interleave(group, dim=2))
    pairs = int(mask.sum()) * (q.shape[0] if mask.shape[0] == 1 else 1)
    return out, lse.contiguous(), pairs * q.shape[2]


def bwd_bound(b, tq, tk, h, h_kv, d, dtype, pairs, seg,
              products: int, n_out: int) -> tuple[float, str]:
    """Least time for one backward kernel: q, do, k, v, lse and delta
    (and segments) read once, its f32 outputs (``n_out`` tensors of q's
    shape for K3, of k's for K4) written once, over the memory rate;
    ``products`` times 2*D flops per valid (q, k, head) pair over the
    peak rate of the inputs' type; the larger of the two."""
    es = torch.tensor([], dtype=dtype).element_size()
    nbytes = ((2 * b * tq * h + 2 * b * tk * h_kv) * d * es
              + 2 * b * h * tq * 4 + (b * (tq + tk) * 4 if seg else 0))
    out_rows = b * tq * h if n_out == 1 else 2 * b * tk * h_kv
    nbytes += out_rows * d * 4
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
    t_b, t_f = nbytes / H100_BYTES_PER_S, products * 2 * d * pairs / peak
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def sdpa_bwd_fn(q, k, v, do, mask=None):
    """The backward of one PyTorch attention call through autograd,
    the forward excluded (yardstick only, never called by the port):
    causal, or under ``mask`` ([B, Tq, Tk] bool, True where a query
    sees a key) passed as one boolean ``attn_mask``."""
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    group = q.shape[2] // k.shape[2]
    kw = (dict(is_causal=True) if mask is None
          else dict(attn_mask=mask[:, None]))
    if "enable_gqa" in (F.scaled_dot_product_attention.__doc__ or ""):
        out = F.scaled_dot_product_attention(qt, kt, vt,
                                             enable_gqa=group > 1, **kw)
    else:
        out = F.scaled_dot_product_attention(
            qt, kt.repeat_interleave(group, dim=1),
            vt.repeat_interleave(group, dim=1), **kw)
    dot = do.transpose(1, 2)
    return lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                       retain_graph=True)


def phase_flash_bwd(fa) -> tuple[dict, dict, dict]:
    """K3 and K4 against their plain version (bf16: the rounding
    ``flash_block_grads_reference``, and the f32 oracle
    ``attention_block_grads`` at BWD_BF16_ORACLE_TOL; f32: the oracle),
    each case on the route its dtype picks; returns the kernels-line
    rows of both at the training shape and, by shape, callables of each
    kernel, the plain version and the library call there."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    bf, f32 = torch.bfloat16, torch.float32
    full = dict(b=8, t=2048, tk=2048, h=16, h_kv=4, d=64, dtype=bf,
                window=None, seg=False, q_off=0, k_off=0, k_end=None)
    cases = [
        full,
        dict(full, window=256),
        dict(full, seg=True),
        dict(full, b=2, d=128),
        dict(full, b=2, t=1024, tk=1024, dtype=f32, seg=True),
        # ring hops: a later q block against an earlier K/V block, and
        # a short q block against a longer, tail-padded one
        dict(full, b=2, t=1024, tk=1024, q_off=1024, k_off=0),
        dict(full, b=2, t=512, tk=1024, q_off=1536, k_off=512,
             k_end=1400, window=700),
    ]
    # the small head dims in both dtypes: a causal block, one with a
    # window and segments, and a ring hop with a window and a valid-key
    # end; then the gang probes' step (2 rows of 16 tokens, 4 heads of
    # 8, f32), the kernels-line row of the small dims
    for d in SMALL_DIMS:
        for dtype in (bf, f32):
            cases += [
                dict(full, b=2, t=256, tk=256, h=8, h_kv=4, d=d,
                     dtype=dtype),
                dict(full, b=2, t=256, tk=256, h=4, h_kv=2, d=d,
                     dtype=dtype, window=100, seg=True),
                dict(full, b=2, t=128, tk=256, h=4, h_kv=2, d=d,
                     dtype=dtype, q_off=192, k_off=64, k_end=300,
                     window=150)]
    cases.append(dict(full, b=2, t=16, tk=16, h=4, h_kv=4, d=8, dtype=f32,
                      probe="the gang probes' step"))
    rows, probes = {}, {"K3": {}, "K4": {}}
    for c in cases:
        b, t, tk, h, h_kv, d, dtype = (c["b"], c["t"], c["tk"], c["h"],
                                       c["h_kv"], c["d"], c["dtype"])

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev,
                               dtype=torch.float32).to(dtype)

        q, do = rnd(b, t, h, d), rnd(b, t, h, d)
        k, v = rnd(b, tk, h_kv, d), rnd(b, tk, h_kv, d)
        seg_q = seg_k = None
        if c["seg"]:
            cuts = torch.randint(0, 512, (b, t), generator=gen, device=dev)
            seg_q = seg_k = (torch.cumsum((cuts == 0).to(torch.int32),
                                          dim=1).to(torch.int32)
                             .contiguous())
        out, lse, pairs = block_forward(fa, q, k, v, c["q_off"],
                                        c["k_off"], c["window"],
                                        c["k_end"], seg_q, seg_k)
        delta = fa.attention_delta(do, out)
        del out
        kw = dict(causal=True, window=c["window"], k_valid_end=c["k_end"],
                  q_segments=seg_q, k_segments=seg_k)
        args = (q, k, v, do, delta, lse, c["q_off"], c["k_off"])
        before = flash_routes(fa)
        dq = fa.flash_bwd_dq(*args, **kw)
        dk, dv = fa.flash_bwd_dkv(*args, **kw)
        route = "tc" if dtype == bf else "f32"
        took = {n: flash_routes(fa)[n] - before[n] for n in before
                if n.startswith("flash_bwd")}
        if took != {n: int(n.endswith(route)) for n in took}:
            fail(f"K3/K4 at {c} took the routes {took}")
        kw_plain = dict(kw)
        del kw_plain["causal"]
        plain_bwd = (fa.flash_block_grads_reference if dtype == bf
                     else fa.attention_block_grads)
        grads = {"dq": dq, "dk": dk, "dv": dv}

        def gaps(ref):
            return {n: ((grads[n] - want).abs().max().item(),
                        want.abs().max().item())
                    for n, want in zip(grads, ref)}

        for name, got in grads.items():
            if not torch.isfinite(got).all():
                fail(f"K3/K4 non-finite {name} at {c}")
        errs = gaps(plain_bwd(*args, True, d ** -0.5, **kw_plain))
        oracle = (gaps(fa.attention_block_grads(*args, True, d ** -0.5,
                                                **kw_plain))
                  if dtype == bf else {})
        torch.cuda.synchronize()
        ms_dq = cuda_ms(lambda: fa.flash_bwd_dq(*args, **kw), iters=5,
                        warmup=1)
        ms_dkv = cuda_ms(lambda: fa.flash_bwd_dkv(*args, **kw), iters=5,
                         warmup=1)
        plain_ms = cuda_ms(lambda: plain_bwd(
            *args, True, d ** -0.5, **kw_plain), iters=3, warmup=1)
        plain = (c["window"] is None and not c["seg"] and c["q_off"] == 0
                 and c["k_off"] == 0 and t == tk)
        lib_fn = None
        if plain:
            lib_fn = sdpa_bwd_fn(q, k, v, do)
        elif dtype == f32:
            # the f32 card steps' shape: causal and segments as one
            # boolean mask
            lib_fn = sdpa_bwd_fn(q, k, v, do, fa.block_mask(
                t, tk, c["q_off"], c["k_off"], True, c["window"],
                c["k_end"], seg_q, seg_k, q.device))
        lib_ms = cuda_ms(lib_fn, iters=5, warmup=1) if lib_fn else None
        seg = c["seg"]
        b_dq = bwd_bound(b, t, tk, h, h_kv, d, dtype, pairs, seg, 3, 1)
        b_dkv = bwd_bound(b, t, tk, h, h_kv, d, dtype, pairs, seg, 4, 2)
        ok = all(e <= BWD_TOL * max(1.0, m) for e, m in errs.values())
        ok_oracle = all(e <= BWD_BF16_ORACLE_TOL * max(1.0, m)
                        for e, m in oracle.values())
        label = (f"B={b} Tq={t} Tk={tk} H={h} Hkv={h_kv} D={d} "
                 f"window={c['window']} seg={seg} q_off={c['q_off']} "
                 f"k_off={c['k_off']} k_valid_end={c['k_end']} "
                 f"{str(dtype).removeprefix('torch.')} route={route}")
        vs_oracle = (" vs the f32 oracle: " + " ".join(
            f"{n} max|d|={e:.3g}" for n, (e, _) in oracle.items())
            + f" (tol {BWD_BF16_ORACLE_TOL} x max(1, max|ref|)) "
            f"{'ok' if ok_oracle else 'FAIL'};" if oracle else "")
        print(f"K3/K4 {label}: vs {plain_bwd.__name__}: "
              + " ".join(f"{n} max|d|={e:.3g} (max|ref| {m:.3g})"
                         for n, (e, m) in errs.items())
              + f" (tol {BWD_TOL} x max(1, max|ref|));{vs_oracle}"
              f" K3_ms={ms_dq:.4f} "
              f"K4_ms={ms_dkv:.4f} plain_ms(dq,dk,dv)={plain_ms:.4f} "
              f"library_ms(sdpa backward)={fmt(lib_ms)} "
              f"K3_bound_us={b_dq[0] * 1e3:.2f} ({b_dq[1]}) "
              f"K4_bound_us={b_dkv[0] * 1e3:.2f} ({b_dkv[1]}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"K3/K4 disagree with their plain version at {c}")
        if not ok_oracle:
            fail(f"bf16 K3/K4 stray from the f32 oracle at {c}")
        if "probe" in c:
            shape = (f"B={b} T={t} H={h} Hkv={h_kv} D={d} causal "
                     f"{str(dtype).removeprefix('torch.')} ({c['probe']})")
            SMALL_D_ROWS["K3"] = dict(
                shape=shape, max_abs_err=errs["dq"][0], ms=ms_dq,
                plain_ms=plain_ms, bound_ms=b_dq[0], bound_by=b_dq[1],
                library_ms=lib_ms)
            SMALL_D_ROWS["K4"] = dict(
                shape=shape, max_abs_err=max(errs["dk"][0], errs["dv"][0]),
                ms=ms_dkv, plain_ms=plain_ms, bound_ms=b_dkv[0],
                bound_by=b_dkv[1], library_ms=lib_ms)
        if c is full or (dtype == f32 and d >= 64):
            shape = ("B=8 T=2048 (main path)" if c is full else
                     f"B={b} T={t} segments f32 (the CUDA-core route)")
            plain_fn = (lambda a=args, k2=kw_plain, dd=d, fn=plain_bwd:
                        fn(*a, True, dd ** -0.5, **k2))
            probes["K3"][shape] = dict(
                kernel=lambda a=args, k2=kw: fa.flash_bwd_dq(*a, **k2),
                plain=plain_fn, library=lib_fn)
            probes["K4"][shape] = dict(
                kernel=lambda a=args, k2=kw: fa.flash_bwd_dkv(*a, **k2),
                plain=plain_fn, library=lib_fn)
        if c is full:
            rows["K3"] = dict(max_abs_err=errs["dq"][0], ms=ms_dq,
                              plain_ms=plain_ms, bound_ms=b_dq[0],
                              bound_by=b_dq[1], library_ms=lib_ms)
            rows["K4"] = dict(max_abs_err=max(errs["dk"][0],
                                              errs["dv"][0]),
                              ms=ms_dkv, plain_ms=plain_ms,
                              bound_ms=b_dkv[0], bound_by=b_dkv[1],
                              library_ms=lib_ms)
    return rows["K3"], rows["K4"], probes


def moe_heavy_config(**kw):
    """The JAX package's MoE shape (tools/bench_moe.py ``heavy``): vocab
    1024, d_model 512, 4 layers, 4 heads, d_head 64, d_ff 4096, 16
    experts, top_k 2, max_seq 1024, bf16; gmm dispatch."""
    from k8s_dra_driver_tpu_torch.models.transformer import (
        TransformerConfig)
    fields = dict(vocab=1024, d_model=512, n_layers=4, n_heads=4,
                  d_head=64, d_ff=4096, n_experts=16, top_k=2,
                  max_seq=1024, dtype=torch.bfloat16, moe_dispatch="gmm")
    fields.update(kw)
    return TransformerConfig(**fields)


def gmm_layouts(gen, rows: int, e: int, bm: int, d: int) -> dict:
    """Padded group sizes (int64 on the card, as the routing layer makes
    them) of the four layouts the grouped-matmul checks run: the
    router's own top-2 routing of seeded activations, every row to one
    expert, experts 4-11 empty, and half the rows (a long dead tail)."""
    dev = torch.device("cuda")
    xt = torch.randn((rows // 2, d), generator=gen, device=dev)
    router = torch.randn((d, e), generator=gen, device=dev) * d ** -0.5
    ids = torch.topk(xt @ router, 2, dim=-1).indices.reshape(-1)
    counts = torch.zeros(e, dtype=torch.long, device=dev).scatter_add_(
        0, ids, torch.ones_like(ids))
    one = torch.zeros(e, dtype=torch.long, device=dev)
    one[3] = rows
    holes = torch.full((e,), rows // 8, dtype=torch.long, device=dev)
    holes[4:12] = 0
    half = torch.full((e,), rows // (2 * e), dtype=torch.long, device=dev)
    return {name: ((c + bm - 1) // bm) * bm for name, c in (
        ("router", counts), ("one expert", one), ("empty 4-11", holes),
        ("dead tail", half))}


def gmm_bound(live: int, m: int, k: int, n: int, used: int, es: int,
              dw: bool, e: int) -> tuple[float, str]:
    """Least time for one grouped matmul from this run's data: the live
    rows' 2*K*N flops over the bf16 (or f32) peak; bytes: K5 reads the
    live rows of x and the experts that have rows and writes all M rows
    of out; K6 reads the live rows of x and dy and writes the E f32
    expert gradients."""
    flops = 2 * live * k * n
    if dw:
        nbytes = live * (k + n) * es + e * k * n * 4
    else:
        nbytes = live * k * es + used * k * n * es + m * n * es
    peak = H100_BF16_FLOPS if es == 2 else H100_F32_FLOPS
    t_b, t_f = nbytes / H100_BYTES_PER_S, flops / peak
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def grouped_mm_fn(a, b, group_sizes, dw: bool):
    """``(callable, None)`` of one PyTorch call computing the same
    grouped product (``torch._grouped_mm`` with cumulative offsets;
    yardstick only, never called by the port), or ``(None, reason)``."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None, "torch._grouped_mm is absent from this PyTorch"
    offs = torch.cumsum(group_sizes, 0).to(torch.int32)
    call = ((lambda: fn(a.t(), b, offs=offs)) if dw
            else (lambda: fn(a, b, offs=offs)))
    try:
        call()
        torch.cuda.synchronize()
    except (RuntimeError, TypeError, ValueError) as exc:
        return None, f"torch._grouped_mm refused: {str(exc)[:120]}"
    return call, None


def phase_gmm(gm) -> tuple[dict, dict, dict]:
    """K5 (gmm, plain and transposed read) and K6 (gmm dw) against their
    plain versions at the moe_heavy shapes: 18,432 static rows, E=16,
    block_m 128, d 512, f 4096, for both expert matrices, in bf16 (K5
    and K6 on the tensor-core route) and f32 (the CUDA-core route), over
    four group layouts; bf16 K6 is timed at the hot expert beside the
    router layout.  Returns the kernels-line rows of K5
    and K6 at the main path's case (router layout, bf16, w_in side),
    and, by case, callables of the kernel, its plain version and the
    library call for the device-time phase."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    cfg = moe_heavy_config()
    e, d, f, bm = cfg.n_experts, cfg.d_model, cfg.d_ff, 128
    rows = MOE_B * MOE_T * cfg.top_k                      # 16,384 routed
    m = rows + e * bm                                     # static bound
    layouts = gmm_layouts(gen, rows, e, bm, d)
    rows_out, probes = {}, {"K5": {}, "K6": {}}
    dw_times = {}   # bf16 K6 kernel ms by (label, layout)
    for dtype in (torch.bfloat16, torch.float32):
        tol5 = GMM_TOL[dtype]
        es = torch.tensor([], dtype=dtype).element_size()
        w_in = (torch.randn((e, d, f), generator=gen, device=dev)
                * d ** -0.5).to(dtype)
        w_out = (torch.randn((e, f, d), generator=gen, device=dev)
                 * f ** -0.5).to(dtype)
        for name, gs in layouts.items():
            live = int(gs.sum())
            used = int((gs > 0).sum())
            mask = (torch.arange(m, device=dev) < live)[:, None]

            def rnd(cols):
                return (torch.randn((m, cols), generator=gen, device=dev)
                        * mask).to(dtype)

            x, h, dy_h, dy_x = rnd(d), rnd(f), rnd(f), rnd(d)
            cases = (
                ("K5 w_in", "fwd", (x, w_in, False), f),
                ("K5 w_out", "fwd", (h, w_out, False), d),
                ("K5 dx w_in^T", "fwd", (dy_h, w_in, True), d),
                ("K5 dx w_out^T", "fwd", (dy_x, w_out, True), f),
                ("K6 dw_in", "dw", (x, dy_h), None),
                ("K6 dw_out", "dw", (h, dy_x), None),
            )
            bf16 = dtype == torch.bfloat16
            main_layout = name == "router" and bf16
            for label, kind, args, n_out in cases:
                if kind == "fwd":
                    a, w, tr = args
                    kernel = (lambda a=a, w=w, tr=tr, gs=gs:
                              gm.gmm_forward(a, w, gs, bm, transpose_w=tr))
                    plain = (lambda a=a, w=w, tr=tr, gs=gs:
                             gm.gmm_reference(a, w, gs, bm, transpose_w=tr))
                    k_dim, n_dim, tol = a.shape[1], n_out, tol5
                    bound = gmm_bound(live, m, k_dim, n_dim, used, es,
                                      False, e)
                    lib_b = w.transpose(1, 2) if tr else w
                else:
                    a, dy = args
                    kernel = (lambda a=a, dy=dy, gs=gs:
                              gm.gmm_dw(a, dy, gs, bm))
                    plain = (lambda a=a, dy=dy, gs=gs:
                             gm.gmm_dw_reference(a, dy, gs, bm))
                    k_dim, n_dim, tol = a.shape[1], dy.shape[1], DW_TOL
                    bound = gmm_bound(live, m, k_dim, n_dim, used, es,
                                      True, e)
                    lib_b = dy
                # K5 and K6 alike: bf16 on the tensor cores, f32 on the
                # CUDA cores
                counter = "tc_launches" if kind == "fwd" else "dw_tc_launches"
                before = getattr(gm, counter)
                got, want = kernel(), plain()
                torch.cuda.synchronize()
                if getattr(gm, counter) != before + bf16:
                    fail(f"{label} took the wrong route at {name} {dtype}")
                if not torch.isfinite(got.float()).all():
                    fail(f"{label} non-finite output at {name} {dtype}")
                err = (got.float() - want.float()).abs().max().item()
                scale = max(1.0, want.float().abs().max().item())
                # K5: the dead tail's rows; K6: experts without rows
                zeros = got[gs == 0] if kind == "dw" else got[live:]
                dead_ok = int(torch.count_nonzero(zeros)) == 0
                ok = err <= tol * scale and dead_ok
                direct = ""
                if kind == "dw" and bf16:
                    # the backward's form: bf16 written from the
                    # accumulators must be the f32 output rounded
                    same = torch.equal(gm.gmm_dw(a, dy, gs, bm,
                                                 out_dtype=torch.bfloat16),
                                       got.to(torch.bfloat16))
                    ok = ok and same
                    direct = f" bf16 out == f32 out rounded: {same}"
                ms = plain_ms = lib_ms = lib = lib_err = None
                why = "not timed at this layout"
                hot = kind == "dw" and bf16 and name == "one expert"
                if name == "router" or hot:
                    ms = trusted(label, "kernel_ms", cuda_ms(
                        kernel, iters=5, warmup=1), bound[0], kernel)
                    plain_ms = cuda_ms(plain, iters=3, warmup=1)
                    lib, why = grouped_mm_fn(a, lib_b, gs, kind == "dw")
                    if lib:
                        ref = want if kind == "dw" else want[:live]
                        res = lib() if kind == "dw" else lib()[:live]
                        lib_err = (res.float() - ref.float()).abs().max()
                        lib_ms = trusted(label, "library_ms", cuda_ms(
                            lib, iters=5, warmup=1), bound[0], lib)
                        del res, ref
                    if kind == "dw" and bf16:
                        dw_times[(label, name)] = ms
                route = "tensor cores" if bf16 else "CUDA cores"
                print(f"{label} M={m} K={k_dim} N={n_dim} E={e} bm={bm} "
                      f"live={live} ({name}) "
                      f"{str(dtype).removeprefix('torch.')} ({route}): "
                      f"max|d|={err:.3g} (tol {tol} x max(1, max|plain| "
                      f"{scale:.3g})) zeros kept={dead_ok}{direct} "
                      f"kernel_ms={fmt(ms)} plain_ms={fmt(plain_ms)} "
                      f"library_ms="
                      f"{fmt(lib_ms) if lib else 'none: ' + why}"
                      + (f" (library max|d| {float(lib_err):.3g})"
                         if lib_err is not None else "")
                      + f" bound_us={bound[0] * 1e3:.2f} ({bound[1]}) "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    fail(f"{label} disagrees with its plain version at "
                         f"{name} {dtype}")
                if hot:
                    probes["K6"][f"{label} one expert bf16"] = dict(
                        kernel=kernel)
                if main_layout:
                    main = label in ("K5 w_in", "K6 dw_in")
                    shape = f"{label} router bf16" + (" (main path)" if main
                                                      else "")
                    probes[label[:2]][shape] = dict(
                        kernel=kernel, plain=plain,
                        **({"library": lib} if lib else {}))
                    if main:
                        rows_out[label[:2]] = dict(
                            max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound[0], bound_by=bound[1],
                            library_ms=lib_ms)
                del got, want
    for label in ("K6 dw_in", "K6 dw_out"):
        one, router = (dw_times[(label, n)] for n in ("one expert",
                                                      "router"))
        print(f"{label} bf16 kernel_ms: one expert {fmt(one)} against "
              f"the router layout's {fmt(router)}"
              + (f" ({one / router:.2f}x)" if one and router else ""),
              flush=True)
    return rows_out["K5"], rows_out["K6"], probes


def int8_bound(g: int, m: int, k: int, n: int, es: int, x_rows: int,
               peak: float) -> tuple[float, str]:
    """Least time for one int8 product: x (``x_rows`` rows of K: M, or
    G * M when every expert reads its own x) in its dtype, the G int8
    weights, their f32 scales and the output read or written once, over
    the memory rate; 2*K flops per output element over ``peak``."""
    nbytes = x_rows * k * es + g * k * n + g * n * 4 + g * m * n * es
    t_b, t_f = nbytes / H100_BYTES_PER_S, 2 * g * m * k * n / peak
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def int8pack_fn(x, q, scale):
    """``(callable, None)`` of ``torch._weight_int8pack_mm`` (weight
    [N, K] int8, scales [N]: the same W8A16 function; yardstick only,
    never called by the port), or ``(None, reason)``."""
    fn = getattr(torch, "_weight_int8pack_mm", None)
    if fn is None:
        return None, "torch._weight_int8pack_mm is absent from this PyTorch"
    w_nk = q.t().contiguous()
    sc = scale.reshape(-1).to(x.dtype)
    try:
        fn(x, w_nk, sc)
        torch.cuda.synchronize()
    except (RuntimeError, TypeError, ValueError, NotImplementedError) as exc:
        return None, f"torch._weight_int8pack_mm refused: {str(exc)[:120]}"
    return (lambda: fn(x, w_nk, sc)), None


#: K7a's products on one tp=2 rank of the 154M at 8 rows (multichip (b)'s
#: int8-weight variant), K x N: this rank's heads of wq/wk/wv, its rows
#: of wo, its hidden units of w_in/w_out, its d-slice of the
#: unembedding, whose x is a column slice of the rank's whole x
TP_RANK_K7 = {"wq": (1024, 512), "wk/wv": (1024, 128), "wo": (512, 1024),
              "w_in": (1024, 2048), "w_out": (2048, 1024),
              "unembed": (512, 32000)}


def int8_cases() -> list:
    """(kind, M, K, N, label) of the K7 checks: the 154M decode step's
    products (wq/wo 1024x1024, wk/wv 1024x256, w_in, w_out, the
    unembedding) at 1, 8 and 64 slots; the 660M model's MLP at 8 rows
    (tools/bench_int8.py:39); 96 and 768 rows past the M <= 64 gate; a
    ragged shape; moe_heavy's expert products at 8 rows (E = 16)."""
    cases = [("K7a", m, k, n, "154M")
             for m in (1, 8, 64)
             for k, n in ((1024, 1024), (1024, 256), (1024, 4096),
                          (4096, 1024), (1024, 32000))]
    cases += [("K7a", 8, 2048, 8192, "660M"), ("K7a", 8, 8192, 2048, "660M"),
              ("K7a", 96, 1024, 4096, "off-gate"),
              ("K7a", 768, 1024, 4096, "off-gate"),
              ("K7a", 5, 1000, 333, "ragged"),
              ("K7b", 8, 512, 4096, "moe_heavy w_in, x shared by 16 experts"),
              ("K7b", 8, 4096, 512, "moe_heavy w_out, transposed view")]
    cases += [("K7a", 8, k, n, f"154M tp=2 rank {leaf}")
              for leaf, (k, n) in TP_RANK_K7.items()]
    return cases


def phase_int8(qm) -> tuple[dict, dict, dict]:
    """K7a and K7b against their plain versions over ``int8_cases`` in
    bf16 and f32, timed with the L2 flushed before every call.  Returns
    the kernels-line rows at the main paths' cases (K7a: the 154M
    unembedding at 8 slots, bf16; K7b: the shared-x up-projection at
    moe_heavy, f32, as the int8 MoE drain runs it) and, by case,
    callables for the device-time phase."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    e = 16
    rows, probes = {}, {"K7a": {}, "K7b": {}}
    for dtype in (torch.bfloat16, torch.float32):
        es = torch.tensor([], dtype=dtype).element_size()
        peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
        name = str(dtype).removeprefix("torch.")
        for kind, m, k, n, label in int8_cases():
            g = e if kind == "K7b" else 1
            w = torch.randn((g, k, n), generator=gen, device=dev) * k ** -0.5
            qt = qm.quantize(w, (1,))                 # scale [g, 1, n]
            del w
            q_bf = qt.q.to(torch.bfloat16)
            if kind == "K7a":
                q2, s2 = qt.q[0], qt.scale[0]
                x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
                if label == "154M tp=2 rank unembed":
                    # _unembed's column slice of the rank's [M, 2K] x
                    x = torch.randn((m, 2 * k), generator=gen,
                                    device=dev).to(dtype)[:, k:]
                kernel = (lambda x=x, q2=q2, s2=s2:
                          qm.int8_matmul(x, q2, s2))
                plain = (lambda x=x, q2=q2, s2=s2:
                         qm.int8_matmul_reference(x, q2, s2))
                xb, wb = x.to(torch.bfloat16), q_bf[0]
                cublas = lambda xb=xb, wb=wb: torch.matmul(xb, wb)
                lib, why = int8pack_fn(x, q2, s2)
                x_rows = m
            else:
                shared = k == 512
                if shared:     # btd,edf->btef: one x, stride 0 over experts
                    x = torch.randn((m, k), generator=gen,
                                    device=dev).to(dtype)
                    x3 = x[None].expand(g, m, k)
                else:          # btef,efd->bted: [rows, experts, f] read
                    x = torch.randn((m, g, k), generator=gen,
                                    device=dev).to(dtype)
                    x3 = x.permute(1, 0, 2)
                y = torch.empty((m, g, n), dtype=dtype, device=dev)
                kernel = (lambda x3=x3, qt=qt, y=y: qm.int8_bmm(
                    x3, qt.q, qt.scale, out=y.permute(1, 0, 2)))
                plain = (lambda x3=x3, qt=qt:
                         qm.int8_bmm_reference(x3, qt.q, qt.scale))
                xb = x3.to(torch.bfloat16).contiguous()
                cublas = lambda xb=xb, wb=q_bf: torch.bmm(xb, wb)
                if shared:     # one W8A16 product on the [K, E*N] weight
                    lib, why = int8pack_fn(
                        x, qt.q.permute(1, 0, 2).reshape(k, g * n),
                        qt.scale.reshape(g * n))
                else:
                    lib, why = None, ("each expert reads its own x: no "
                                      "single PyTorch call computes a "
                                      "batched W8A16 product")
                x_rows = m if shared else g * m
            route = qm.int8_route(dtype)
            plan = qm.pick_int8_tiles(g, m, k, n, dtype,
                                      batched=kind == "K7b")
            before = qm.tc_launches
            out, want = kernel(), plain()
            torch.cuda.synchronize()
            if qm.tc_launches != before + (route == "tensor_cores"):
                fail(f"{kind} took the wrong route at M={m} K={k} N={n} "
                     f"{name}")
            if not torch.isfinite(out.float()).all():
                fail(f"{kind} non-finite output at M={m} K={k} N={n} {name}")
            err = (out.float() - want.float()).abs().max().item()
            scale = max(1.0, want.float().abs().max().item())
            tol = INT8_TOL[dtype]
            ok = err <= tol * scale
            bound = int8_bound(g, m, k, n, es, x_rows, peak)
            shape = (f"M={m} K={k} N={n}" + (f" E={g}" if g > 1 else "")
                     + f" ({label}) {name}")
            ms = trusted(f"{kind} {shape}", "kernel_ms", cold_ms(kernel),
                         bound[0], kernel)
            plain_ms = cold_ms(plain, iters=5, warmup=1)
            cublas_ms = cold_ms(cublas)
            lib_ms = (trusted(f"{kind} {shape}", "library_ms", cold_ms(lib),
                              bound[0], lib) if lib else None)
            print(f"{kind} {shape} ({route.replace('_', ' ')}; "
                  f"{plan.splits} splits of {plan.k_chunk} rows, "
                  f"{plan.blocks} blocks, ring {plan.ring}): "
                  f"max|d|={err:.3g} (tol {tol} x max(1, max|plain| "
                  f"{scale:.3g})) kernel_ms={fmt(ms)} plain_ms="
                  f"{plain_ms:.4f} cublas_bf16_ms={cublas_ms:.4f} "
                  f"library_ms={fmt(lib_ms) if lib else 'none: ' + why} "
                  f"bound_us={bound[0] * 1e3:.2f} ({bound[1]}) "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"{kind} disagrees with its plain version at {shape}")
            main = ((kind, m, k, n, dtype) == ("K7a", 8, 1024, 32000,
                                                torch.bfloat16)
                    or (kind, k, dtype) == ("K7b", 512, torch.float32))
            probe = {"kernel": kernel}
            if main:
                probe.update(plain=plain, cublas_bf16=cublas,
                             **({"library": lib} if lib else {}))
                rows[kind] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=bound[0], bound_by=bound[1],
                                  library_ms=lib_ms)
            probes[kind][shape + (" (main path)" if main else "")] = probe
            if label.startswith("154M tp=2 rank"):
                TP_RANK_ROWS["K7a"].append(dict(
                    shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound[0], bound_by=bound[1],
                    library_ms=lib_ms, plan=plan._asdict()))
            del out, want
    return rows["K7a"], rows["K7b"], probes


def serving_config():
    """The 154M configuration: vocab 32000, d_model 1024, 8 layers, 16
    heads, 4 KV heads, d_head 64, d_ff 4096, max_seq 2048, bf16."""
    from k8s_dra_driver_tpu_torch.models.transformer import (
        TransformerConfig)
    return TransformerConfig(vocab=32000, d_model=1024, n_layers=8,
                             n_heads=16, n_kv_heads=4, d_head=64,
                             d_ff=4096, max_seq=2048, dtype=torch.bfloat16)


def serving_model():
    """(cfg, params): the 154M serving configuration at full width and
    depth in bf16, random weights from generator seed 0 on the card."""
    from k8s_dra_driver_tpu_torch.models.transformer import init_params
    cfg = serving_config()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    n_params = sum(p.numel() for p in param_tensors(params))
    print(f"model: 154M serving config, {n_params} parameters, bf16",
          flush=True)
    return cfg, params


def s8_r24(vocab: int):
    """The bench's s8_r24 drain: 24 requests, prompt lengths cycling
    96/48/72/24 from numpy seed 0, max_new 48; requests 3, 9, 15 and 21
    are sampled (temperature 0.8, engine top_k 50)."""
    from k8s_dra_driver_tpu_torch.models.serving import Request
    rng = np.random.default_rng(0)
    lengths = [96, 48, 72, 24]
    reqs = []
    for i in range(24):
        prompt = rng.integers(0, vocab, lengths[i % 4]).astype(np.int32)
        sampled = i % 6 == 3
        reqs.append(Request(uid=f"r{i}", prompt=prompt, max_new=48,
                            temperature=0.8 if sampled else 0.0,
                            seed=100 + i))
    return reqs


def teacher_forced(params, cfg, finished, reqs) -> float:
    """Every greedy stream: one forward over prompt + generated tokens;
    each generated token's logit must be within TF_MARGIN of that
    position's max.  Returns the worst gap seen."""
    from k8s_dra_driver_tpu_torch.models.transformer import forward
    by_uid = {r.uid: r for r in reqs}
    worst = 0.0
    with torch.no_grad():
        for f in finished:
            req = by_uid[f.uid]
            if len(f.tokens) != len(req.prompt) + req.max_new:
                fail(f"{f.uid}: {len(f.tokens)} tokens, expected "
                     f"{len(req.prompt) + req.max_new}")
            toks = torch.as_tensor(f.tokens, dtype=torch.long,
                                   device=params["embed"].device)
            if int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab:
                fail(f"{f.uid}: token out of range")
            if req.temperature > 0:
                continue
            logits = forward(params, toks[None], cfg)[0].float()
            if not torch.isfinite(logits).all():
                fail(f"{f.uid}: non-finite logits")
            n = f.n_prompt
            pred = logits[n - 1:-1]
            gen = toks[n:]
            gap = (pred.max(dim=-1).values
                   - pred.gather(1, gen[:, None])[:, 0])
            worst = max(worst, float(gap.max()))
    if worst > TF_MARGIN:
        fail(f"teacher-forced check: a greedy token's logit is "
             f"{worst:.3f} below its position's max (margin "
             f"{TF_MARGIN})")
    return worst


#: dispatch labels of the decode layer's forward passes: the decode
#: steps (one row per slot, so at most 8 rows) and the prefills (any
#: number of rows); every forward pass of a drain carries one of them
DECODE_PASSES = ("decode_step_rows", "paged_decode_step_rows")
PREFILL_PASSES = ("prefill", "prefill_suffix", "prefill_adopt_rows",
                  "suffix_fill_adopt")


def k7_passes(launched: int, per_pass: int, passes, label: str) -> int:
    """The forward passes that went through K7: ``launched`` launches
    of ``per_pass`` each.  Fails unless that division is exact and its
    quotient lies between the drain's decode steps (each of at most 64
    rows, so each must go through K7) and all its forward passes."""
    decode, prefill = passes
    n, rest = divmod(launched, per_pass)
    if rest or not decode <= n <= decode + prefill:
        fail(f"{label}: {launched} launches are not {per_pass} per pass "
             f"over between {decode} decode steps and {decode + prefill} "
             f"forward passes")
    return n


def drain(engine_cls, params, cfg, reqs, fa, pa, label, **kw):
    """Drive one engine over ``reqs`` with the kernel counters zeroed
    just before and read just after; returns (finished, counts, stats,
    passes): ``passes`` is (decode passes, prefills), the decode
    layer's forward passes by dispatch label, the fused block's passes
    (its graphs' replayed steps and warm-ups) counted as decode
    passes.  ``stats`` adds the run's wall seconds, generated tokens,
    decode steps, dispatches plus readbacks, the graphs' draft-model
    passes (``draft_passes``) and, under ``run``, the change of every
    ``..._total`` counter over the run, to the engine's.

    A step engine (``chain_steps`` 1) warms up on a separate engine; a
    fused engine drains the traffic once before the measured run on
    the same engine, so that every graph the run replays is captured
    before it."""
    from k8s_dra_driver_tpu_torch.models import quant as qm
    from k8s_dra_driver_tpu_torch.utils import dispatch
    fused = kw.get("chain_steps", 1) > 1
    warm = engine_cls(params, cfg, slots=8, **kw)
    for r in reqs if fused else reqs[:2]:
        warm.submit(r if fused else type(r)(uid="w" + r.uid,
                                            prompt=r.prompt, max_new=2))
    warm.run()
    eng = warm if fused else engine_cls(params, cfg, slots=8, **kw)
    del warm
    for r in reqs:
        eng.submit(r)
    graphs = eng._graphs

    def graph_counts():
        return ((0, 0, 0) if graphs is None else
                (graphs.passes, graphs.replays, graphs.draft_passes))

    before = graph_counts()
    stats0 = eng.stats()
    torch.cuda.synchronize()
    fa.launches = fa.tc_launches = 0
    pa.launches = 0
    for name in qm.launches:
        qm.launches[name] = 0
    qm.tc_launches = 0
    t0 = time.perf_counter()
    with dispatch.track() as t:
        done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    require_fwd_route(fa, label, cfg.dtype == torch.bfloat16)
    # K7 takes x in the model's dtype: every launch on its route
    k7 = sum(qm.launches.values())
    if qm.tc_launches != (k7 if cfg.dtype == torch.bfloat16 else 0):
        fail(f"{label}: {qm.tc_launches} of {k7} K7 launches on the "
             f"tensor-core route, expected "
             f"{'all' if cfg.dtype == torch.bfloat16 else 'none'}")
    counts = {"flash_fwd": fa.launches, "flash_fwd_tc": fa.tc_launches,
              "paged_decode": pa.launches, **qm.launches,
              "int8_tc": qm.tc_launches}
    passes = tuple(sum(t.by_label.get(k, 0) for k in labels)
                   for labels in (DECODE_PASSES, PREFILL_PASSES))
    after = graph_counts()
    passes = (passes[0] + after[0] - before[0], passes[1])
    stats = eng.stats()
    gen_tokens = sum(len(f.tokens) - f.n_prompt for f in done)
    steps = stats["decode_steps_total"] - stats0["decode_steps_total"]
    stats.update(wall_s=wall, generated=gen_tokens, steps=steps,
                 replays=after[1] - before[1],
                 draft_passes=after[2] - before[2],
                 dispatches_readbacks=t.dispatches + t.readbacks,
                 by_label=t.by_label,
                 run={k: v - stats0[k] for k, v in stats.items()
                      if k.endswith("_total")})
    if len(done) != len(reqs):
        fail(f"{label}: {len(done)} of {len(reqs)} requests finished")
    print(f"engine {label}: {len(done)} finished, {gen_tokens} tokens in "
          f"{wall:.3f} s = {gen_tokens / wall:.1f} tokens/s, "
          f"{1e3 * wall / max(steps, 1):.3f} ms per decode step and "
          f"{1e3 * wall / max(gen_tokens, 1):.4f} ms per token (wall), "
          f"kernel launches {counts}", flush=True)
    print(f"engine {label} stats: {json.dumps(stats)}", flush=True)
    return done, counts, stats, passes


def phase_int8_serving(params, cfg, reqs, fa, pa) -> dict:
    """int8 serving at 154M: ``quantize_params`` of the bf16 weights held
    to them on one 8 x 96 forward, then the three int8 drains, each with
    its teacher-forced check against a full forward on the int8 weights
    and 6 K7a launches per layer + 1 for each pass K7 serves (see
    :func:`k7_passes`).  Returns the drains' summed launches."""
    from k8s_dra_driver_tpu_torch.models.quant import (quantize_params,
                                                       quantized_bytes)
    from k8s_dra_driver_tpu_torch.models.serving import ServingEngine
    from k8s_dra_driver_tpu_torch.models.transformer import forward
    qparams = quantize_params(params, cfg)
    stored, full = quantized_bytes(qparams)
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (8, 96)), device="cuda")
    with torch.no_grad():
        ref = forward(params, toks, cfg).float()
        got = forward(qparams, toks, cfg).float()
    rel = float(((got - ref).abs() / ref.std().clamp_min(1e-6)).mean())
    agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    ok = rel < QUANT_MEAN_REL and agree > QUANT_AGREE
    print(f"quantize_params 154M: {stored} bytes stored against {full} in "
          f"bf16 ({stored / full:.3f}); one B=8 T=96 forward, int8 vs bf16 "
          f"weights: mean |d| / std {rel:.4f} (< {QUANT_MEAN_REL}), argmax "
          f"agreement {agree:.4f} (> {QUANT_AGREE}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("quantized logits do not track the full-precision ones")
    per_pass = 6 * cfg.n_layers + 1
    total = {}
    for label, c, kw in (
            ("int8 weights, contiguous", cfg, {}),
            ("int8 weights, contiguous int8 KV",
             dataclasses.replace(cfg, kv_cache_dtype="int8"), {}),
            ("int8 weights, paged", cfg, {"kv_layout": "paged"})):
        done, counts, _, passes = drain(ServingEngine, qparams, c, reqs,
                                        fa, pa, label, top_k=50, **kw)
        paged = "kv_layout" in kw
        if (counts["int8_bmm"] or counts["flash_fwd"] <= 0
                or paged != (counts["paged_decode"] > 0)):
            fail(f"{label}: launches {counts}, expected no K7b, K1 and "
                 f"(paged only) K2")
        n = k7_passes(counts["int8_matmul"], per_pass, passes, label)
        worst = teacher_forced(qparams, cfg, done, reqs)
        print(f"teacher-forced ({label}; the forward over the full "
              f"sequence, at least 72 rows, takes the einsum route): worst "
              f"gap {worst:.4f} <= {TF_MARGIN}; K7a launched "
              f"{counts['int8_matmul']} = {per_pass} x {n} passes of at "
              f"most 64 rows: {passes[0]} decode steps + {n - passes[0]} "
              f"of {passes[1]} prefills", flush=True)
        for name, k in counts.items():
            total[name] = total.get(name, 0) + k
    return total


def phase_int8_moe_serving(fa, pa) -> dict:
    """The moe_heavy drain of ``phase_moe_serving`` on ``quantize_params``
    weights, in f32, dense dispatch (the only one int8 experts take),
    with its teacher-forced check; for each pass K7 serves, K7b twice
    per layer (the expert products) and K7a 4 per layer + 1, over the
    same passes.  Returns the drain's launches."""
    from k8s_dra_driver_tpu_torch.models.quant import quantize_params
    from k8s_dra_driver_tpu_torch.models.serving import ServingEngine
    from k8s_dra_driver_tpu_torch.models.transformer import init_params
    cfg = moe_heavy_config(dtype=torch.float32, moe_dispatch="dense")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(2),
                         device="cuda")
    qparams = quantize_params(params, cfg)
    del params
    reqs = s8_r24(cfg.vocab)
    label = "moe_heavy f32 int8 weights, contiguous"
    done, counts, _, passes = drain(ServingEngine, qparams, cfg, reqs, fa,
                                    pa, label, top_k=50)
    n = k7_passes(counts["int8_matmul"], 4 * cfg.n_layers + 1, passes,
                  label + " (K7a)")
    if (k7_passes(counts["int8_bmm"], 2 * cfg.n_layers, passes,
                  label + " (K7b)") != n or counts["flash_fwd"] <= 0):
        fail(f"int8 MoE drain launched {counts}: K7a and K7b over "
             f"different passes, or no K1")
    worst = teacher_forced(qparams, cfg, done, reqs)
    print(f"teacher-forced (moe_heavy f32 int8 weights, dense dispatch, "
          f"einsum route): worst gap {worst:.4f} <= {TF_MARGIN}; K7a "
          f"{counts['int8_matmul']}, K7b {counts['int8_bmm']} launches over "
          f"{n} passes of at most 64 rows: {passes[0]} decode steps + "
          f"{n - passes[0]} of {passes[1]} prefills", flush=True)
    return counts


#: the fused engine's block length: the JAX package's serving probe
#: drains s8_r24 at chain_steps=47 (bench.py:1222,
#: tools/bench_serving.py:53)
FUSED_CHAIN = 47
#: a fused drain pays at least this many times fewer host dispatches
#: plus readbacks per generated token than the step engine on the same
#: traffic: the JAX package's gate (tests/test_decode.py:426-452)
FUSED_AMORTIZATION = 8


def phase_fused_serving(params, cfg, reqs, fa, pa) -> dict:
    """Fused generation blocks on the card: each variant drains s8_r24
    twice in this call, on the step engine and at ``chain_steps`` =
    FUSED_CHAIN, where every block is one replay of a captured CUDA
    graph.  Variants: the 154M on bf16 weights (K1 for the fills,
    outside the graph), on ``quantize_params`` weights (K7a inside the
    graph, tensor-core route) with the contiguous cache and with the
    contiguous int8 KV cache, and the moe_heavy drain in f32 (dense
    dispatch; no K7).  Gates: f32 streams byte-equal to the step
    engine's; bf16 greedy streams within TF_MARGIN teacher-forced (the
    byte-equal count printed); K7 launches exact, those inside the
    graphs included; no block outside a graph; dispatches plus
    readbacks per token at least FUSED_AMORTIZATION times fewer.
    Returns the fused drains' summed launches, and the 154M drains'
    (finished, stats) by "bf16 step", "bf16 fused", "int8 step" and
    "int8 fused", which the speculative phase compares with."""
    from k8s_dra_driver_tpu_torch.models.quant import quantize_params
    from k8s_dra_driver_tpu_torch.models.serving import ServingEngine
    from k8s_dra_driver_tpu_torch.models.transformer import init_params
    qparams = quantize_params(params, cfg)
    refs = {}
    moe_cfg = moe_heavy_config(dtype=torch.float32)
    moe_params = init_params(moe_cfg, torch.Generator(
        device="cuda").manual_seed(2), device="cuda")
    per_pass = 6 * cfg.n_layers + 1
    total: dict = {}
    summary = []
    for label, p, c, r in (
            ("154M bf16 weights, contiguous", params, cfg, reqs),
            ("154M int8 weights, contiguous", qparams, cfg, reqs),
            ("154M int8 weights, contiguous int8 KV", qparams,
             dataclasses.replace(cfg, kv_cache_dtype="int8"), reqs),
            ("moe_heavy f32, contiguous", moe_params, moe_cfg,
             s8_r24(moe_cfg.vocab))):
        int8 = p is qparams
        step, _, s_stats, _ = drain(ServingEngine, p, c, r, fa, pa,
                                    f"{label}, chain_steps=1", top_k=50)
        done, counts, stats, passes = drain(
            ServingEngine, p, c, r, fa, pa,
            f"{label}, chain_steps={FUSED_CHAIN}", top_k=50,
            chain_steps=FUSED_CHAIN)
        if c is cfg:
            tag = "int8" if int8 else "bf16"
            refs[f"{tag} step"] = (step, s_stats)
            refs[f"{tag} fused"] = (done, stats)
        blocks = stats["by_label"].get("decode_fused_rows", 0)
        stray = [k for k in DECODE_PASSES if stats["by_label"].get(k)]
        if stray or blocks <= 0 or blocks != stats["replays"]:
            fail(f"{label}: {blocks} blocks, {stats['replays']} graph "
                 f"replays, decode labels {stray}: every block must be "
                 f"one graph replay")
        if counts["flash_fwd"] <= 0 or counts["int8_bmm"] \
                or bool(counts["int8_matmul"]) != int8:
            fail(f"{label}: launches {counts}, expected K1 and "
                 f"{'K7a' if int8 else 'no K7'}")
        if int8:
            n = k7_passes(counts["int8_matmul"], per_pass, passes, label)
            print(f"{label}: K7a launched {counts['int8_matmul']} = "
                  f"{per_pass} x {n} passes: {passes[0]} decode passes "
                  f"(in {blocks} graph replays) + "
                  f"{n - passes[0]} of {passes[1]} prefills", flush=True)
        by_uid = {f.uid: f.tokens for f in step}
        same = sum(np.array_equal(f.tokens, by_uid[f.uid]) for f in done)
        if c.dtype == torch.float32:
            if same != len(done):
                fail(f"{label}: {len(done) - same} f32 streams differ from "
                     f"the step engine's")
        else:
            worst = teacher_forced(p, c, done, r)
            print(f"teacher-forced ({label}, fused): worst gap "
                  f"{worst:.4f} <= {TF_MARGIN}", flush=True)
        per_tok = (s_stats["dispatches_readbacks"] / s_stats["generated"],
                   stats["dispatches_readbacks"] / stats["generated"])
        if per_tok[0] < FUSED_AMORTIZATION * per_tok[1]:
            fail(f"{label}: {per_tok[1]:.4f} dispatches + readbacks per "
                 f"token fused against {per_tok[0]:.4f} stepwise: not "
                 f"{FUSED_AMORTIZATION}x fewer")
        row = {"label": label, "streams_equal": same,
               "streams": len(done),
               "dispatch_readbacks_per_token": per_tok,
               "graphs": stats["graph_captures_total"],
               "capture_s": stats["graph_capture_s"]}
        for key, st in (("step", s_stats), ("fused", stats)):
            row[key] = {
                "tokens_per_s": st["generated"] / st["wall_s"],
                "wall_ms_per_step": 1e3 * st["wall_s"] / max(st["steps"], 1),
                "wall_ms_per_token": 1e3 * st["wall_s"] / st["generated"],
                "decode_steps": st["steps"]}
        print(f"fused {label} ({card_line()}): {same}/{len(done)} streams "
              f"byte-equal to the step engine's; tokens/s "
              f"{row['step']['tokens_per_s']:.1f} -> "
              f"{row['fused']['tokens_per_s']:.1f}; wall ms per decode step "
              f"{row['step']['wall_ms_per_step']:.3f} -> "
              f"{row['fused']['wall_ms_per_step']:.3f}, per token "
              f"{row['step']['wall_ms_per_token']:.4f} -> "
              f"{row['fused']['wall_ms_per_token']:.4f}; dispatches + "
              f"readbacks per token {per_tok[0]:.4f} -> {per_tok[1]:.4f}; "
              f"{row['graphs']} graphs captured in {row['capture_s']:.3f} s, "
              f"{blocks} blocks each one replay", flush=True)
        summary.append(row)
        for name, k in counts.items():
            total[name] = total.get(name, 0) + k
    print(f"fused serving: {json.dumps(summary)}", flush=True)
    return total, refs


#: the speculative drains' draft length: the engines' default, and the
#: JAX package's
SPEC_DRAFT_LEN = 4
#: the f32 self-draft drain's least accept rate: the target drafting
#: for itself accepts every greedy proposal but after a near tie between
#: a 5-row window and one-row steps, and a row's last window emits only
#: what its max_new leaves (about 37 of a row's 40 drafts)
SPEC_SELF_ACCEPT = 0.8
#: total variation between the accept's emitted tokens and the
#: closed-form filtered target distribution at 16384 rows: the bounds
#: of tests/test_speculative.py:166 (first emitted token) and :175 (the
#: bonus token of a full accept)
SPEC_TV_FIRST = 0.03
SPEC_TV_BONUS = 0.05
#: the full-accept share of the accept math's rows, against its closed
#: form prod_i sum_x min(p_i(x), q_i(x)) (binomial spread at 16384 rows
#: is about 0.004)
SPEC_SHARE_TOL = 0.01
#: the step path's speculative launch sites; a fused speculative drain
#: runs none of them (every window is inside a graph)
SPEC_STEP_LABELS = ("decode_window_rows", "paged_window_rows",
                    "draft_propose_rows", "draft_sample_rows",
                    "draft_ngram_rows", "spec_accept_rows")


def spec_row(stats) -> dict:
    """A drain's end-to-end numbers: tokens/s, wall ms a decode step
    (a window, on a speculative engine), decode steps, dispatches plus
    readbacks a token."""
    return {"tokens_per_s": stats["generated"] / stats["wall_s"],
            "wall_ms_per_step": 1e3 * stats["wall_s"] / max(stats["steps"],
                                                            1),
            "steps": stats["steps"],
            "dispatch_readbacks_per_token": (stats["dispatches_readbacks"]
                                             / stats["generated"])}


def same_streams(done, ref) -> int:
    by_uid = {f.uid: f.tokens for f in ref}
    return sum(np.array_equal(f.tokens, by_uid[f.uid]) for f in done)


def phase_spec_accept(dev) -> None:
    """The accept math alone on the card: ``spec_accept_rows`` over
    16384 rows of one fixed window (V=8, K=2, the fixtures of
    tests/test_speculative.py:114-176 drawn with numpy, proposals drawn
    from q by inverse CDF), each row with its own generator, against
    the closed-form filtered target distribution ``p``."""
    from k8s_dra_driver_tpu_torch.models import decode as dm
    v, k, rows, temp = 8, 2, 16384, 0.9
    rng = np.random.default_rng(3)
    tl = rng.normal(size=(k + 1, v)).astype(np.float32)
    dl = rng.normal(size=(k, v)).astype(np.float32)

    def probs(logits, top_k, top_p):
        return torch.softmax(dm._filter_logits(
            torch.as_tensor(logits, device=dev), temp, top_k, top_p), -1)

    def tv(toks, want) -> float:
        emp = np.bincount(toks, minlength=v) / len(toks)
        return 0.5 * float(np.abs(emp - want).sum())

    for name, top_k, top_p, draft in (("no filter", 0, 0.0, dl),
                                      ("top_k 4", 4, 0.0, dl),
                                      ("top_p 0.8", 0, 0.8, dl),
                                      ("perfect draft", 0, 0.0, tl[:k])):
        p, q = probs(tl, top_k, top_p), probs(draft, top_k, top_p)
        u = np.random.default_rng(4).random((rows, k))
        cdf = np.cumsum(q.double().cpu().numpy(), axis=-1)
        props = np.stack([np.minimum(np.searchsorted(cdf[i], u[:, i],
                                                     side="right"), v - 1)
                          for i in range(k)], 1)
        gens = [torch.Generator(device=dev).manual_seed(r)
                for r in range(rows)]
        t0 = time.perf_counter()
        emit, a = dm.spec_accept_rows(
            p.new_tensor(tl)[None].expand(rows, -1, -1),
            torch.as_tensor(props, device=dev), q[None].expand(rows, -1, -1),
            gens, torch.full((rows,), temp, device=dev), top_k, top_p)
        emit, a = emit.cpu().numpy(), a.cpu().numpy()
        wall = time.perf_counter() - t0
        p = p.double().cpu().numpy()
        first = tv(emit[:, 0], p[0])
        full = a == k
        share = float(np.prod(np.minimum(p[:k], q.double().cpu().numpy())
                              .sum(-1)))
        line = (f"spec accept math ({name}, {rows} rows, V={v} K={k}, on "
                f"the card, {wall:.2f} s): first emitted token TV "
                f"{first:.4f} < {SPEC_TV_FIRST}; full accepts "
                f"{full.mean():.4f} against closed form {share:.4f}")
        ok = first < SPEC_TV_FIRST and abs(full.mean() - share) < \
            SPEC_SHARE_TOL
        if name == "no filter":
            bonus = tv(emit[full, k], p[k])
            line += f"; bonus token TV {bonus:.4f} < {SPEC_TV_BONUS}"
            ok &= bonus < SPEC_TV_BONUS
        if name == "perfect draft":
            line += f"; least accepts {int(a.min())} (all {k})"
            ok &= int(a.min()) == k
        print(line + (" ok" if ok else " FAIL"), flush=True)
        if not ok:
            fail(f"speculative accept math ({name}) off the target "
                 f"distribution")


def phase_spec_serving(params, cfg, reqs, fa, pa, refs) -> dict:
    """Speculative decoding on the card (``draft_len`` SPEC_DRAFT_LEN,
    engine top_k 50), each drain beside the non-speculative drain of
    this call in ``refs`` ((finished, stats) by name): the n-gram source
    on the contiguous cache step by step and fused (``chain_steps`` =
    FUSED_CHAIN, every block one graph replay); the target as its own
    draft, likewise, on bf16 and on ``quantize_params`` weights (K7a in
    the graph for target and draft); the n-gram source on the paged
    cache, on the full pool and on a 41-block pool with max_seq 256;
    the f32 self-draft step by step beside an f32 plain drain; the
    accept math alone; the ported probe in bf16 and f32.

    Gates: every greedy stream within TF_MARGIN teacher-forced; fused
    drains byte-equal to the step drains of the same source and
    weights, all 24 streams; K1 in every drain; K7a exactly 49 a target
    pass and 49 a draft pass (the graphs' passes counted) in the int8
    drains; no K2 and at least one spec trim in the paged drains, a
    preemption on the small pool; every fused block one graph replay;
    the f32 self-draft accept rate at least SPEC_SELF_ACCEPT; the
    accept math's TV bounds; the probe byte-equal to the closed-form
    ramp.  The streams byte-equal to the non-speculative engine's are
    counted, not gated (a 5-row window and five one-row steps may sum
    in different orders).  Returns the drains' summed launches and
    their (finished, stats) by "spec <label>", which the LoRA phase
    compares with."""
    from k8s_dra_driver_tpu_torch.models.quant import quantize_params
    from k8s_dra_driver_tpu_torch.models.serving import ServingEngine
    from k8s_dra_driver_tpu_torch.models.specprobe import spec_decode_probe
    t_phase = time.perf_counter()
    kd = SPEC_DRAFT_LEN
    qparams = quantize_params(params, cfg)
    per_pass = 6 * cfg.n_layers + 1
    ngram = {"draft_source": "ngram"}
    self_bf16 = {"draft_params": params, "draft_cfg": cfg}
    self_int8 = {"draft_params": qparams, "draft_cfg": cfg}
    fused = {"chain_steps": FUSED_CHAIN}
    # a request whose prompt takes at most 64 rows fills through K7: its
    # target fill and its draft fill
    small_fills = 2 * sum(r.prompt.size <= 64 for r in reqs)
    f32 = map_params(params, lambda t: t.float())
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    base32, total, stats32, _ = drain(ServingEngine, f32, cfg32, reqs, fa,
                                      pa, "f32, contiguous, chain_steps=1",
                                      top_k=50)
    refs = dict(refs, **{"f32 step": (base32, stats32)})
    summary = []
    steps: dict = {}
    streams: dict = {}
    for label, p, c, kw, ref in (
            ("n-gram, contiguous", params, cfg, ngram, "bf16 step"),
            ("n-gram, contiguous, fused", params, cfg, dict(ngram, **fused),
             "bf16 fused"),
            ("self-draft, contiguous", params, cfg, self_bf16, "bf16 step"),
            ("self-draft, contiguous, fused", params, cfg,
             dict(self_bf16, **fused), "bf16 fused"),
            ("self-draft int8 weights, contiguous", qparams, cfg, self_int8,
             "int8 step"),
            ("self-draft int8 weights, contiguous, fused", qparams, cfg,
             dict(self_int8, **fused), "int8 fused"),
            ("n-gram, paged", params, cfg, dict(ngram, kv_layout="paged"),
             "bf16 paged"),
            ("n-gram, paged, 41 blocks", params, cfg,
             dict(ngram, kv_layout="paged", max_seq=256, kv_blocks=41),
             "bf16 paged-preempt"),
            ("self-draft f32, contiguous", f32, cfg32,
             {"draft_params": f32, "draft_cfg": cfg32}, "f32 step")):
        is_fused = "chain_steps" in kw
        paged = "kv_layout" in kw
        done, counts, stats, passes = drain(
            ServingEngine, p, c, reqs, fa, pa, f"spec {label}", top_k=50,
            draft_len=kd, **kw)
        streams[f"spec {label}"] = (done, stats)
        run, labels = stats["run"], stats["by_label"]
        rate = (run["speculative_accepted_total"]
                / max(1, run["speculative_drafts_total"]))
        if counts["flash_fwd"] <= 0:
            fail(f"spec {label}: no K1 launch")
        if paged and (counts["paged_decode"] or
                      run["kv_spec_trims_total"] <= 0):
            fail(f"spec {label}: {counts['paged_decode']} K2 launches (a "
                 f"window reads through the gather) and "
                 f"{run['kv_spec_trims_total']} spec trims")
        if "kv_blocks" in kw and run["kv_preemptions_total"] < 1:
            fail(f"spec {label}: the 41-block pool forced no preemption")
        extra = ""
        if is_fused:
            blocks = labels.get("decode_spec_fused_rows", 0)
            stray = [k for k in SPEC_STEP_LABELS + DECODE_PASSES
                     if labels.get(k)]
            if stray or blocks <= 0 or blocks != stats["replays"]:
                fail(f"spec {label}: {blocks} blocks, {stats['replays']} "
                     f"graph replays, step labels {stray}: every block "
                     f"must be one graph replay")
            replayed = passes[0] - run["graph_captures_total"]
            alive = run["speculative_drafts_total"] // kd
            extra = (f"; {stats['graph_captures_total']} graphs captured "
                     f"in {stats['graph_capture_s']:.3f} s, {blocks} blocks "
                     f"each one replay, {replayed} windows replayed, "
                     f"{8 * replayed - alive} of {8 * replayed} "
                     f"slot-windows frozen")
            pair = steps[label.removesuffix(", fused")]
            equal = same_streams(done, pair)
            if equal != len(done):
                by_uid = {f.uid: f.tokens for f in pair}
                diff = {f.uid: int(np.argmax(f.tokens != by_uid[f.uid]))
                        - f.n_prompt for f in done
                        if not np.array_equal(f.tokens, by_uid[f.uid])}
                fail(f"spec {label}: {len(done) - equal} streams differ "
                     f"from the step-by-step speculative drain's (uid: "
                     f"first differing generated token) {diff}")
            extra += (f"; {equal}/{len(done)} streams byte-equal to the "
                      f"step drain's")
        else:
            steps[label] = done
        if p is qparams:
            target = labels.get("decode_window_rows", 0) + passes[0]
            draft = stats["draft_passes"] + (kd + 1) * (
                labels.get("draft_propose_rows", 0)
                + labels.get("draft_sample_rows", 0))
            want = per_pass * (target + draft + small_fills)
            if counts["int8_matmul"] != want or counts["int8_bmm"]:
                fail(f"spec {label}: K7a launched {counts['int8_matmul']}, "
                     f"expected {per_pass} x ({target} target + {draft} "
                     f"draft passes + {small_fills} fills of <= 64 rows)")
            extra += (f"; K7a {counts['int8_matmul']} = {per_pass} x "
                      f"({target} target + {draft} draft passes + "
                      f"{small_fills} fills)")
        if "f32" in label and rate < SPEC_SELF_ACCEPT:
            fail(f"spec {label}: accept rate {rate:.4f} below "
                 f"{SPEC_SELF_ACCEPT}")
        worst = teacher_forced(p, c, done, reqs)
        base_done, base_stats = refs[ref]
        same = same_streams(done, base_done)
        row = {"label": label, "reference": ref, "accept_rate": rate,
               "windows": run["speculative_windows_total"],
               "streams_equal_to_plain": same, "streams": len(done),
               "teacher_forced_worst": worst,
               "plain": spec_row(base_stats), "spec": spec_row(stats)}
        summary.append(row)
        print(f"spec {label} ({card_line()}): accept rate {rate:.4f}, "
              f"{row['windows']} windows; tokens/s "
              f"{row['plain']['tokens_per_s']:.1f} -> "
              f"{row['spec']['tokens_per_s']:.1f}; wall ms per decode step "
              f"{row['plain']['wall_ms_per_step']:.3f} "
              f"({row['plain']['steps']} steps) -> "
              f"{row['spec']['wall_ms_per_step']:.3f} (a window); "
              f"dispatches + readbacks per token "
              f"{row['plain']['dispatch_readbacks_per_token']:.4f} -> "
              f"{row['spec']['dispatch_readbacks_per_token']:.4f}; {same}/"
              f"{len(done)} streams byte-equal to the non-speculative "
              f"engine's ({ref}); teacher-forced worst gap {worst:.4f} <= "
              f"{TF_MARGIN}" + extra, flush=True)
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n
    del f32, base32
    phase_spec_accept(params["embed"].device)
    for dtype in (torch.bfloat16, torch.float32):
        probe = spec_decode_probe(repeats=2, dtype=dtype,
                                  device=params["embed"].device)
        print(f"spec probe ({card_line()}): {json.dumps(probe)}", flush=True)
        if not probe["byte_equal"]:
            fail(f"spec probe in {probe['dtype']}: streams differ from the "
                 f"closed-form ramp")
    print(f"spec serving: {json.dumps(summary)}", flush=True)
    print(f"spec phase wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return total, streams


#: the LoRA phase (``phase_lora_serving``): adapters of rank 16 from
#: ``make_adapter`` at its default scale, six of them over four resident
#: pool slots, so the drains evict and cold-load
LORA_RANK = 16
LORA_ADAPTERS = 6
LORA_RESIDENT = 4
#: each s8_r24 request's adapter: the JAX test's roster
#: (tests/test_serving_lora.py:216-217) over six adapters, twice: six
#: base rows, and the sampled requests (r3, r9, r15, r21) on adapters
LORA_ROSTER = (None, "l0", "l1", "l0", "l2", None, "l3", "l4", "l5", "l2",
               "l1", None) * 2


def lora_pool(cfg, names, n_resident: int):
    """A pool on the card holding ``names``, each adapter regenerated
    from its seed, so every pool of the phase agrees on what a name
    means."""
    from k8s_dra_driver_tpu_torch.serving_lora import (AdapterManifest,
                                                       AdapterPool,
                                                       make_adapter)
    pool = AdapterPool(cfg, LORA_RANK, n_resident)
    for name in names:
        pool.register(AdapterManifest(name, LORA_RANK, source=make_adapter(
            cfg, LORA_RANK, seed=40 + int(name[1:]))))
    return pool


def buffer_ptrs(pool) -> list:
    return [b.data_ptr() for layer in pool.buffers for b in layer]


def lora_teacher_forced(params, cfg, finished, reqs, pool) -> float:
    """Every greedy adapter stream, teacher-forced the way the engine
    decodes it: the prompt through the base model (prefill stays
    base-model; its last logits choose the first token), then one
    ``decode_window_rows`` pass over the generated tokens with the
    row's adapter.  Each generated token's logit must be within
    TF_MARGIN of its position's max.  Returns the worst gap."""
    from k8s_dra_driver_tpu_torch.models import decode as dm
    by_uid = {r.uid: r for r in reqs}
    dev = params["embed"].device
    worst = 0.0
    with torch.no_grad():
        for f in finished:
            req = by_uid[f.uid]
            if len(f.tokens) != len(req.prompt) + req.max_new:
                fail(f"{f.uid}: {len(f.tokens)} tokens, expected "
                     f"{len(req.prompt) + req.max_new}")
            if req.temperature > 0 or req.adapter is None:
                continue
            toks = torch.as_tensor(f.tokens, dtype=torch.long, device=dev)
            n = f.n_prompt
            slot = pool.acquire(req.adapter)
            cache = dm.init_cache(cfg, 1, len(f.tokens), device=dev)
            first, cache = dm.forward_with_cache(params, toks[None, :n], cfg,
                                                 cache, first_chunk=True)
            rest, _ = dm.decode_window_rows(
                params, toks[None, n:-1], cfg, cache,
                torch.tensor([n], device=dev),
                (torch.tensor([slot], device=dev), pool.buffers))
            pool.release(slot)
            pred = torch.cat([first[0, -1:], rest[0]]).float()
            if not torch.isfinite(pred).all():
                fail(f"{f.uid}: non-finite logits")
            gen = toks[n:]
            gap = pred.max(dim=-1).values - pred.gather(1, gen[:, None])[:, 0]
            worst = max(worst, float(gap.max()))
    if worst > TF_MARGIN:
        fail(f"teacher-forced check with adapters: a greedy token's logit "
             f"is {worst:.3f} below its position's max (margin "
             f"{TF_MARGIN})")
    return worst


def lora_oracles(params, cfg, reqs, names, **kw) -> dict:
    """Each adapter's requests, and the base requests, alone on an engine
    of the drains' 8 slots whose pool holds only that adapter (so every
    product has the drain's shapes): {uid: tokens}."""
    from k8s_dra_driver_tpu_torch.models.serving import ServingEngine
    out = {}
    for name in [None] + names:
        pool = None if name is None else lora_pool(cfg, [name], 1)
        eng = ServingEngine(params, cfg, slots=8, top_k=50,
                            adapter_pool=pool, **kw)
        for r in reqs:
            if r.adapter == name:
                eng.submit(r)
        out.update({f.uid: f.tokens for f in eng.run()})
    return out


def phase_lora_serving(params, cfg, reqs, fa, pa, refs) -> dict:
    """Multi-adapter LoRA serving on the card: s8_r24 with LORA_ROSTER's
    adapters (rank LORA_RANK, LORA_ADAPTERS adapters over LORA_RESIDENT
    pool slots, engine top_k 50), each drain on a fresh pool beside the
    adapter-less drain of this call in ``refs`` ((finished, stats) by
    name): contiguous step by step and fused (``chain_steps`` =
    FUSED_CHAIN, the graphs reading the pool in place), paged (K2),
    ``quantize_params`` weights step by step and fused (K7a), the
    n-gram source step by step and fused, and f32 step by step.

    Gates: every pool buffer at its address after the drain (cold loads
    and evictions write in place); every base row byte-equal to the
    adapter-less drain (the null slot adds an exact zero); at least one
    adapter row apart from it; each fused drain byte-equal to its step
    drain, 24/24; K1 in every drain, K2 exactly n_layers a paged step
    call, K7a exactly 49 a pass; every fused block one graph replay and
    no capture in the measured run while it cold-loads adapters (the
    adapter-less fused drain captures none there either); greedy streams
    within TF_MARGIN teacher-forced, adapter rows through
    :func:`lora_teacher_forced`; in f32 every stream byte-equal to one-
    adapter oracle engines of the same slot count (in bf16 counted).
    Then the pool's probe at the 154M in bf16 and f32 (f32 byte-equal
    gated).  Returns the drains' summed launches."""
    from k8s_dra_driver_tpu_torch.models.quant import quantize_params
    from k8s_dra_driver_tpu_torch.models.serving import ServingEngine
    from k8s_dra_driver_tpu_torch.serving_lora.probe import (
        lora_serving_probe)
    t_phase = time.perf_counter()
    names = [f"l{i}" for i in range(LORA_ADAPTERS)]
    lreqs = [dataclasses.replace(r, adapter=a)
             for r, a in zip(reqs, LORA_ROSTER)]
    base = {r.uid for r in lreqs if r.adapter is None}
    qparams = quantize_params(params, cfg)
    f32 = map_params(params, lambda t: t.float())
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    per_pass = 6 * cfg.n_layers + 1
    ngram = {"draft_source": "ngram", "draft_len": SPEC_DRAFT_LEN}
    fused = {"chain_steps": FUSED_CHAIN}
    total: dict = {}
    summary = []
    steps: dict = {}
    for label, p, c, kw, ref, pair in (
            ("contiguous", params, cfg, {}, "bf16 step", None),
            ("contiguous, fused", params, cfg, fused, "bf16 fused",
             "contiguous"),
            ("paged", params, cfg, {"kv_layout": "paged"}, "bf16 paged",
             None),
            ("int8 weights, contiguous", qparams, cfg, {}, "int8 step",
             None),
            ("int8 weights, contiguous, fused", qparams, cfg, fused,
             "int8 fused", "int8 weights, contiguous"),
            ("n-gram, contiguous", params, cfg, ngram,
             "spec n-gram, contiguous", None),
            ("n-gram, contiguous, fused", params, cfg, dict(ngram, **fused),
             "spec n-gram, contiguous, fused", "n-gram, contiguous"),
            ("f32, contiguous", f32, cfg32, {}, None, None)):
        pool = lora_pool(c, names, LORA_RESIDENT)
        ptrs = buffer_ptrs(pool)
        done, counts, stats, passes = drain(
            ServingEngine, p, c, lreqs, fa, pa, f"lora {label}", top_k=50,
            adapter_pool=pool, **kw)
        run, labels = stats["run"], stats["by_label"]
        if buffer_ptrs(pool) != ptrs:
            fail(f"lora {label}: an adapter buffer moved")
        if counts["flash_fwd"] <= 0:
            fail(f"lora {label}: no K1 launch")
        if "kv_layout" in kw:
            calls = labels.get("paged_decode_step_rows", 0)
            if calls <= 0 or counts["paged_decode"] != cfg.n_layers * calls:
                fail(f"lora {label}: {counts['paged_decode']} K2 launches "
                     f"over {calls} paged steps, expected {cfg.n_layers} "
                     f"a step")
        if p is qparams:
            k7_passes(counts["int8_matmul"], per_pass, passes,
                      f"lora {label}")
            if counts["int8_bmm"]:
                fail(f"lora {label}: K7b launched")
        note = ""
        if c is cfg32 or label == "contiguous":
            oracle = lora_oracles(p, c, lreqs, names)
            equal = sum(np.array_equal(f.tokens, oracle[f.uid])
                        for f in done)
            if c is cfg32 and equal != len(done):
                fail(f"lora {label}: {len(done) - equal} streams differ "
                     f"from the one-adapter oracle engines'")
            note = (f"; {equal}/{len(done)} streams = one-adapter oracles "
                    f"({'gated' if c is cfg32 else 'counted'})")
        if ref is not None:
            ref_done = {f.uid: f.tokens for f in refs[ref][0]}
            same_base = sum(np.array_equal(f.tokens, ref_done[f.uid])
                            for f in done if f.uid in base)
            moved = sum(not np.array_equal(f.tokens, ref_done[f.uid])
                        for f in done if f.uid not in base)
            if same_base != len(base) or moved < 1:
                fail(f"lora {label}: {same_base}/{len(base)} base rows "
                     f"equal the adapter-less drain's ({ref}), {moved} "
                     f"adapter rows apart from it")
            note += (f"; base rows {same_base}/{len(base)} = adapter-less "
                     f"({ref}), {moved}/{len(done) - len(base)} adapter rows "
                     f"apart")
        if "chain_steps" in kw:
            tag = ("decode_spec_fused_rows" if "draft_source" in kw
                   else "decode_fused_rows")
            blocks = labels.get(tag, 0)
            stray = [k for k in SPEC_STEP_LABELS + DECODE_PASSES
                     if labels.get(k)]
            # a drain without graphs fails the replay gate just below
            ref_run = refs[ref][1]["run"].get("graph_captures_total", 0)
            if stray or blocks <= 0 or blocks != stats["replays"]:
                fail(f"lora {label}: {blocks} blocks, {stats['replays']} "
                     f"graph replays, step labels {stray}: every block "
                     f"must be one graph replay")
            captured = run.get("graph_captures_total", 0)
            if captured != ref_run or run["adapter_cold_loads_total"] <= 0:
                fail(f"lora {label}: {captured} captures in the measured "
                     f"run (adapter-less: {ref_run}) over "
                     f"{run['adapter_cold_loads_total']} cold loads")
            equal = same_streams(done, steps[pair])
            if equal != len(done):
                fail(f"lora {label}: {len(done) - equal} streams differ "
                     f"from the step drain's")
            note += (f"; {equal}/{len(done)} streams = step drain; "
                     f"{stats.get('graph_captures_total', 0)} graphs "
                     f"captured (adapter-less: "
                     f"{refs[ref][1].get('graph_captures_total', 0)}), "
                     f"{captured} in the measured run, {blocks} blocks each "
                     f"one replay")
        else:
            steps[label] = done
        tf_pool = lora_pool(c, names, LORA_ADAPTERS)
        worst = max(teacher_forced(p, c, [f for f in done if f.uid in base],
                                   lreqs),
                    lora_teacher_forced(p, c, done, lreqs, tf_pool))
        del tf_pool
        row = {"label": label, "hits": run["adapter_hits_total"],
               "cold_loads": run["adapter_cold_loads_total"],
               "evictions": run["adapter_evictions_total"],
               "tokens_per_s": stats["generated"] / stats["wall_s"],
               "wall_ms_per_step": 1e3 * stats["wall_s"]
               / max(stats["steps"], 1),
               "teacher_forced_worst": worst}
        summary.append(row)
        print(f"lora {label} ({card_line()}): pool hits {row['hits']}, cold "
              f"loads {row['cold_loads']}, evictions {row['evictions']} in "
              f"the measured run, buffers at their addresses; tokens/s "
              f"{row['tokens_per_s']:.1f}, wall ms per decode step "
              f"{row['wall_ms_per_step']:.3f}; teacher-forced worst gap "
              f"{worst:.4f} <= {TF_MARGIN}" + note, flush=True)
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n
    for p, c in ((params, cfg), (f32, cfg32)):
        probe = lora_serving_probe(rank=LORA_RANK, cfg=c, params=p)
        print(f"lora probe ({card_line()}): {json.dumps(probe)}", flush=True)
        if c is cfg32 and not probe["byte_equal"]:
            fail("lora probe in f32: churn streams differ from the oracle "
                 "engines'")
    # the probe at its reference default (4 heads of 16 over 2, f32,
    # rank 2): K1 at head dim 16
    probe = lora_serving_probe()
    print(f"lora probe at its reference default ({card_line()}): "
          f"{json.dumps(probe)}", flush=True)
    if not probe["byte_equal"]:
        fail("lora probe at its reference default: churn streams differ "
             "from the oracle engines'")
    print(f"lora serving: {json.dumps(summary)}", flush=True)
    print(f"lora phase wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return total


#: the tier acceptance arc at the 154M: a shared prefix of this many
#: tokens is warmed, flushed, and ridden back by a wave of TIER_WAVE
#: requests (prefix + a TIER_SUFFIX-token suffix, max_new TIER_MAX_NEW,
#: two of them sampled); the tiered engine's host arena holds
#: TIER_HOST_BYTES (a 1024-token prefix is an 8 MiB slab in bf16)
TIER_PREFIX = 1024
TIER_SUFFIX = 32
TIER_WAVE = 8
TIER_MAX_NEW = 32
TIER_HOST_BYTES = 256 << 20
#: the tier probe at the 154M: prefix, suffix and churn wave
TIER_PROBE = dict(prefix_len=1024, suffix_len=16, churn_wave=12)
#: the disaggregated and tiered drains of phase_disagg_tiers: four bf16
#: layout pairs, the f32 unified and split drains, four tier waves
DISAGG_DRAINS = 10


def kernel_snapshot(fa, pa) -> dict:
    return {"flash_fwd": fa.launches, "flash_fwd_tc": fa.tc_launches,
            "paged_decode": pa.launches}


def zero_serving_counts(fa, pa) -> None:
    fa.launches = fa.tc_launches = 0
    pa.launches = 0


def disagg_drain(params, cfg, reqs, fa, pa, label, src_kw, dst_kw):
    """Export every request on a prefill engine, then adopt the blocks in
    request order, as slots free, on a decode engine and drain it (8
    slots each, engine top_k 50); the kernel counters are zeroed before
    each side and read after it.  Fails if the decode side launched K1,
    or, on a paged decode engine, K2 other than n_layers times a decode
    step.  Returns (finished, launches of both sides)."""
    from k8s_dra_driver_tpu_torch.models.serving import ServingEngine
    from k8s_dra_driver_tpu_torch.utils import dispatch
    src = ServingEngine(params, cfg, slots=8, top_k=50, **src_kw)
    dst = ServingEngine(params, cfg, slots=8, top_k=50, **dst_kw)
    torch.cuda.synchronize()
    zero_serving_counts(fa, pa)
    t0 = time.perf_counter()
    blocks = [src.prefill_export(r) for r in reqs]
    torch.cuda.synchronize()
    t_export = time.perf_counter() - t0
    require_fwd_route(fa, f"{label} export", cfg.dtype == torch.bfloat16)
    exported = kernel_snapshot(fa, pa)
    zero_serving_counts(fa, pa)
    done, pending = [], list(blocks)
    t0 = time.perf_counter()
    with dispatch.track() as t:
        while pending or dst.active:
            while pending and dst.active < dst.slots:
                dst.adopt_block(pending.pop(0))
            done += dst.step()
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    decoded = kernel_snapshot(fa, pa)
    steps = t.by_label.get("paged_decode_step_rows", 0)
    if decoded["flash_fwd"]:
        fail(f"{label}: the decode side launched K1 {decoded['flash_fwd']} "
             f"times")
    if dst_kw.get("kv_layout") == "paged" and (
            steps <= 0 or decoded["paged_decode"] != cfg.n_layers * steps):
        fail(f"{label}: {decoded['paged_decode']} K2 launches over {steps} "
             f"paged steps, expected {cfg.n_layers} a step")
    if len(done) != len(reqs):
        fail(f"{label}: {len(done)} of {len(reqs)} requests finished")
    gen = sum(len(f.tokens) - f.n_prompt for f in done)
    st = dst.stats()
    print(f"disagg {label} ({card_line()}): {len(blocks)} exports in "
          f"{1e3 * t_export:.1f} ms ({exported['flash_fwd']} K1 launches), "
          f"{st['kv_adoptions_total']} adoptions and {gen} tokens in "
          f"{1e3 * t_decode:.1f} ms = {gen / t_decode:.1f} tokens/s over "
          f"{st['decode_steps_total']} decode steps, {decoded['paged_decode']} "
          f"K2 launches ({steps} paged steps), no K1 on the decode side",
          flush=True)
    return done, {k: exported[k] + decoded[k] for k in exported}


def tier_wave(eng, wave, label):
    """Submit the wave to ``eng`` and drain it, dispatch labels tracked;
    returns (finished by uid, labels, wall seconds)."""
    from k8s_dra_driver_tpu_torch.utils import dispatch
    for r in wave:
        eng.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with dispatch.track() as t:
        done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if len(done) != len(wave):
        fail(f"tier {label}: {len(done)} of {len(wave)} requests finished")
    return {f.uid: f for f in done}, dict(t.by_label), wall


def best_ms(fn, reps: int = 5) -> float:
    """Best host wall of ``reps`` calls of ``fn``, each ended by a device
    synchronize, in ms."""
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return 1e3 * best


def tier_costs(eng, prompt: np.ndarray, n_prefix: int) -> dict:
    """The pieces of a promotion against a recompute on a paged engine
    that holds ``prompt[:n_prefix]`` as a device entry: the demotion
    gather to the host, the slab's crc32, the promotion adopt (host to
    device into fresh blocks), the suffix fill over the promoted rows
    (dense gather + ``prefill_suffix``), and the full-prompt prefill
    that a recompute runs (K1)."""
    from k8s_dra_driver_tpu_torch.models import decode as dec
    from k8s_dra_driver_tpu_torch.models import serving as srv
    from k8s_dra_driver_tpu_torch.serving_kv import slab_checksum
    entry = eng._prefix.entry(prompt[:n_prefix])
    k, v = eng._tier_gather(entry)

    def adopt():
        eng.kv_manager.free_blocks(eng._tier_adopt(k, v))

    toks = torch.as_tensor(prompt, dtype=torch.long, device=eng.device)[None]

    def suffix():
        one = eng._kv_entry_dense(entry, n_prefix)
        srv._prefill_suffix(eng.params, toks[:, n_prefix:], eng.cfg, one)

    def prefill():
        one = dec.init_cache(eng.cfg, 1, eng.max_seq, device=eng.device)
        dec._prefill(eng.params, toks, eng.cfg, one, True)

    with torch.no_grad():
        return {"gather_ms": best_ms(lambda: eng._tier_gather(entry)),
                "crc_ms": best_ms(lambda: slab_checksum(k, v)),
                "adopt_ms": best_ms(adopt), "suffix_fill_ms": best_ms(suffix),
                "prefill_ms": best_ms(prefill),
                "slab_bytes": sum(t.numel() * t.element_size()
                                  for t in k + v)}


def phase_disagg_tiers(params, cfg, reqs, fa, pa, refs) -> dict:
    """Disaggregated prefill/decode and the KV tiers on the 154M.

    (a) s8_r24 in bf16 exported by a paged prefill engine and adopted in
    request order by a paged decode engine, then the three other layout
    pairs: no K1 on any decode side, K2 exactly n_layers a paged decode
    step, every greedy stream within TF_MARGIN teacher-forced; the
    byte-equal count against the unified paged drain of phase 8 printed.
    (b) The same split in f32 (paged into paged): every stream, sampled
    ones included, byte-equal to a unified f32 paged drain of this call.
    (c) The tier acceptance arc: a TIER_PREFIX-token prefix warmed on a
    tiered (host arena TIER_HOST_BYTES), an all-HBM and a recompute
    paged engine, flushed, then a wave of TIER_WAVE requests: the tiered
    streams byte-equal to the all-HBM engine's, with no ``prefill``
    launch and exactly one ``paged_slab_adopt``; the recompute twin's
    greedy streams within TF_MARGIN (equal count printed).  Then the
    prefix spilled to a temporary directory: a fresh engine over it
    reports it on disk and its wave is byte-equal to the all-HBM
    engine's.  The pieces of a promotion and of a recompute are timed
    alone (``tier_costs``).  (d) The tier probe at the 154M in bf16 and f32: promote
    and recompute ms printed; byte-equal gated in f32 (bf16 printed:
    its twin computes the prompt another way), the churn's hit share
    above 0 in both.  Returns the phase's K1 and K2 launches."""
    from k8s_dra_driver_tpu_torch.models.serving import (Request,
                                                         ServingEngine)
    from k8s_dra_driver_tpu_torch.serving_kv.tierprobe import (
        serving_tier_probe)
    t_phase = time.perf_counter()
    total = {"flash_fwd": 0, "flash_fwd_tc": 0, "paged_decode": 0}

    def add(counts):
        for k in total:
            total[k] += counts[k]

    paged, contiguous = {"kv_layout": "paged"}, {}
    ref_p = refs["bf16 paged"][0]
    for src, dst in (("paged", "paged"), ("paged", "contiguous"),
                     ("contiguous", "paged"),
                     ("contiguous", "contiguous")):
        label = f"bf16 {src} -> {dst}"
        kws = [paged if x == "paged" else contiguous for x in (src, dst)]
        done, counts = disagg_drain(params, cfg, reqs, fa, pa, label, *kws)
        add(counts)
        worst = teacher_forced(params, cfg, done, reqs)
        print(f"disagg {label}: teacher-forced worst gap {worst:.4f} <= "
              f"{TF_MARGIN}; {same_streams(done, ref_p)}/{len(done)} "
              f"streams = the unified paged drain (counted)", flush=True)

    f32 = map_params(params, lambda t: t.float())
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    unified, counts, _, _ = drain(ServingEngine, f32, cfg32, reqs, fa, pa,
                                  "disagg f32 unified paged", top_k=50,
                                  kv_layout="paged")
    add(counts)
    done, counts = disagg_drain(f32, cfg32, reqs, fa, pa,
                                "f32 paged -> paged", paged, paged)
    add(counts)
    equal = same_streams(done, unified)
    if equal != len(done):
        fail(f"disagg f32: {len(done) - equal} split streams differ from "
             f"the unified drain's")
    print(f"disagg f32 paged -> paged: {equal}/{len(done)} streams = the "
          f"unified f32 paged drain (gated; sampled included)", flush=True)
    del unified

    rng = np.random.default_rng(7)
    prefix = rng.integers(0, cfg.vocab, TIER_PREFIX).astype(np.int32)
    wave = [Request(uid=f"w{i}", prompt=np.concatenate(
                [prefix, rng.integers(0, cfg.vocab, TIER_SUFFIX).astype(
                    np.int32)]),
                max_new=TIER_MAX_NEW, temperature=0.8 if i in (2, 5) else 0.0,
                seed=200 + i) for i in range(TIER_WAVE)]

    def engine(**kw):
        eng = ServingEngine(params, cfg, slots=8, top_k=50, kv_layout="paged",
                            **kw)
        eng.submit(Request(uid="warm", prompt=prefix, max_new=1))
        eng.run()
        return eng

    tiered = engine(kv_host_bytes=TIER_HOST_BYTES)
    allhbm, recompute = engine(), engine()
    t0 = time.perf_counter()
    tiered._prefix.flush()
    t_demote = time.perf_counter() - t0
    arena = tiered._prefix.host_arena_bytes()
    recompute._prefix.flush()
    if tiered._prefix.demotions < 1 or arena <= 0:
        fail("tier: the flush demoted nothing to the host arena")
    zero_serving_counts(fa, pa)
    got, labels, t_tier = tier_wave(tiered, wave, "tiered")
    add(kernel_snapshot(fa, pa))
    zero_serving_counts(fa, pa)
    hbm, _, t_hbm = tier_wave(allhbm, wave, "all-HBM")
    add(kernel_snapshot(fa, pa))
    zero_serving_counts(fa, pa)
    rec, rec_labels, t_rec = tier_wave(recompute, wave, "recompute")
    add(kernel_snapshot(fa, pa))
    differ = [u for u in got if not np.array_equal(got[u].tokens,
                                                   hbm[u].tokens)]
    if differ:
        fail(f"tier: tiered streams {differ} differ from the all-HBM "
             f"engine's")
    if labels.get("prefill", 0) or labels.get("paged_slab_adopt", 0) != 1:
        fail(f"tier: the tiered wave launched {labels.get('prefill', 0)} "
             f"prefills and {labels.get('paged_slab_adopt', 0)} slab "
             f"adopts, expected 0 and 1")
    worst = teacher_forced(params, cfg, list(rec.values()), wave)
    rec_equal = sum(np.array_equal(rec[u].tokens, hbm[u].tokens)
                    for u in rec)
    st = tiered.stats()
    print(f"tier wave ({card_line()}): demotion flush {1e3 * t_demote:.2f} "
          f"ms ({TIER_PREFIX}-token slab, {arena} bytes in the host "
          f"arena); tiered wave {1e3 * t_tier:.1f} ms, all-HBM "
          f"{1e3 * t_hbm:.1f} ms, recompute {1e3 * t_rec:.1f} ms; tiered = "
          f"all-HBM {len(got)}/{len(got)} (gated); recompute twin = all-HBM "
          f"{rec_equal}/{len(rec)} (counted), its teacher-forced worst gap "
          f"{worst:.4f} <= {TF_MARGIN}; tiered labels prefill "
          f"{labels.get('prefill', 0)}, prefill_suffix "
          f"{labels.get('prefill_suffix', 0)}, paged_slab_adopt "
          f"{labels.get('paged_slab_adopt', 0)}; recompute prefill "
          f"{rec_labels.get('prefill', 0)}; tier stats "
          f"{json.dumps({k: v for k, v in st.items() if 'tier' in k})}",
          flush=True)
    costs = tier_costs(allhbm, wave[0].prompt, TIER_PREFIX)
    print(f"tier costs ({card_line()}, best of 5, host wall to a device "
          f"synchronize): {json.dumps(costs)}", flush=True)
    del tiered, recompute, rec

    with tempfile.TemporaryDirectory() as spill:
        eng = engine(kv_spill_dir=spill)
        t0 = time.perf_counter()
        eng._prefix.flush()
        t_spill = time.perf_counter() - t0
        disk_bytes = eng._prefix.disk_tier_bytes()
        del eng
        fresh = ServingEngine(params, cfg, slots=8, top_k=50,
                              kv_layout="paged", kv_spill_dir=spill)
        residency = fresh.prefix_residency(wave[0].prompt)
        if residency != (TIER_PREFIX, "disk"):
            fail(f"tier: a fresh engine over the spill directory reports "
                 f"{residency}, expected ({TIER_PREFIX}, 'disk')")
        zero_serving_counts(fa, pa)
        disk, labels, t_disk = tier_wave(fresh, wave, "from disk")
        add(kernel_snapshot(fa, pa))
        differ = [u for u in disk if not np.array_equal(disk[u].tokens,
                                                        hbm[u].tokens)]
        if differ or fresh._prefix.promotions != 1:
            fail(f"tier from disk: streams {differ} differ from the all-HBM "
                 f"engine's ({fresh._prefix.promotions} promotions)")
        print(f"tier from disk ({card_line()}): spill flush "
              f"{1e3 * t_spill:.2f} ms, {disk_bytes} bytes on disk; a fresh "
              f"engine reports {residency}, its wave {1e3 * t_disk:.1f} ms, "
              f"{len(disk)}/{len(disk)} streams = all-HBM (gated), "
              f"prefill launches {labels.get('prefill', 0)}", flush=True)
        del fresh

    for p, c in ((params, cfg), (f32, cfg32)):
        probe = serving_tier_probe(cfg=c, params=p, **TIER_PROBE)
        print(f"tier probe ({card_line()}): {json.dumps(probe)}", flush=True)
        if probe["tier_hit_frac"] <= 0:
            fail(f"tier probe {c.dtype}: no tier hit in the churn wave")
        if c is cfg32 and not probe["byte_equal"]:
            fail("tier probe in f32: the promoted streams differ from the "
                 "recompute twin's")
    # the probe at its reference default (8 heads of 32, f32): K1 at head
    # dim 32
    probe = serving_tier_probe()
    print(f"tier probe at its reference default ({card_line()}): "
          f"{json.dumps(probe)}", flush=True)
    if probe["tier_hit_frac"] <= 0 or not probe["byte_equal"]:
        fail(f"tier probe at its reference default: {probe}")
    print(f"disagg/tier phase wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return total


#: the fleet phase (phase_fleet): s8_r24 in FLEET_BURSTS bursts through
#: pools of 8-slot engines, each request with an SLO no run comes near
FLEET_BURSTS = 3
FLEET_SLO_S = 600.0
#: the fleet drains of phase_fleet: the f32 paged and bf16 contiguous
#: oracles, pools (a)-(d)
FLEET_DRAINS = 6
#: copies a migration cost is timed over (phase_fleet (f))
FLEET_MIGRATE_REPS = 10


def fleet_drive(gw, reqs, fa, pa, after_first=None):
    """Submit s8_r24 to ``gw`` in FLEET_BURSTS bursts, one pump step
    after each, ``after_first()`` after the first; then pump until idle.
    The kernel counters are zeroed before and read after, the dispatch
    labels tracked.  Returns (K1/K2 launches, labels, wall seconds)."""
    from k8s_dra_driver_tpu_torch.utils import dispatch
    n = len(reqs) // FLEET_BURSTS
    torch.cuda.synchronize()
    zero_serving_counts(fa, pa)
    t0 = time.perf_counter()
    with dispatch.track() as t:
        for i in range(FLEET_BURSTS):
            for r in reqs[i * n:(i + 1) * n]:
                g = gw.submit(r, slo_s=FLEET_SLO_S)
                if g.status != "queued":
                    fail(f"fleet: {r.uid} refused at the door ({g.status})")
            gw.step()
            if i == 0 and after_first is not None:
                after_first()
        gw.run_until_idle()
    torch.cuda.synchronize()
    return kernel_snapshot(fa, pa), dict(t.by_label), time.perf_counter() - t0


def fleet_exactly_once(gw, reqs, label) -> int:
    """Fail unless every uid finished exactly once and none was refused;
    returns how many outcomes survived a drain (``requeues > 0``)."""
    uids = {r.uid for r in reqs}
    statuses = {g.status for g in gw.outcomes.values()}
    if (gw.refused or set(gw.outcomes) != uids or set(gw.results) != uids
            or statuses != {"finished"}):
        fail(f"fleet {label}: {len(gw.outcomes)} outcomes ({statuses}) and "
             f"{len(gw.refused)} refusals for {len(uids)} requests")
    return sum(g.requeues > 0 for g in gw.outcomes.values())


def fleet_kernels(cfg, counts, labels, label, fills) -> int:
    """Fail unless K2 launched n_layers times a paged decode step and K1
    n_layers times a fresh prefill (``fills``: the labels of the fills
    that run K1), so none inside a decode step; returns the paged
    steps."""
    steps = labels.get("paged_decode_step_rows", 0)
    prefills = sum(labels.get(k, 0) for k in fills)
    if steps <= 0 or counts["paged_decode"] != cfg.n_layers * steps:
        fail(f"fleet {label}: {counts['paged_decode']} K2 launches over "
             f"{steps} paged decode steps, expected {cfg.n_layers} a step")
    if counts["flash_fwd"] != cfg.n_layers * prefills:
        fail(f"fleet {label}: {counts['flash_fwd']} K1 launches over "
             f"{prefills} fresh prefills, expected {cfg.n_layers} each and "
             f"none in a decode step")
    return steps


def fleet_byte_equal(gw, ref, label, gate: bool) -> int:
    """Streams of ``gw`` equal to the oracle drain ``ref``'s; fails when
    ``gate`` and any differs.  Returns the equal count."""
    by_uid = {f.uid: f.tokens for f in ref}
    equal = sum(np.array_equal(f.tokens, by_uid[u])
                for u, f in gw.results.items())
    if gate and equal != len(by_uid):
        fail(f"fleet {label}: {len(by_uid) - equal} streams differ from "
             f"the single-engine oracle's")
    return equal


def metric_value(text: str, pattern: str) -> float:
    m = re.search(pattern, text, re.M)
    if m is None:
        fail(f"fleet: no sample matches {pattern!r}")
    return float(m.group(1))


def migrate_cost(mig, entry) -> dict:
    """Mean and best ms of FLEET_MIGRATE_REPS same-card migrations of
    ``entry`` (the migrator synchronizes the card before its clock
    reads), its bytes and the mean rate."""
    walls = []
    for _ in range(FLEET_MIGRATE_REPS):
        mig.migrate_entry(entry)
        walls.append(mig.last_event[0])
    nbytes = mig.last_event[1]
    mean = sum(walls) / len(walls)
    return {"bytes": nbytes, "mean_ms": 1e3 * mean,
            "best_ms": 1e3 * min(walls), "GB_per_s": nbytes / mean / 1e9}


def phase_fleet(params, cfg, reqs, fa, pa) -> dict:
    """The fleet gateway and the two-role pool over port engines on the
    154M, s8_r24 in three bursts of 8, every replica on this card.

    (a) Unified pool in f32, paged KV (each engine's prefix store on):
    two replicas, r0 downed through the health signal after its first
    dispatch wave.  Gated: every uid finished exactly once, 1 drain, the
    requeued count equal to the outcomes with ``requeues > 0`` (at least
    1), the replacement up (1 dead, 2 ready), every stream byte-equal to
    one f32 paged engine of the same slots draining s8_r24, K2 n_layers
    a paged decode step and K1 n_layers a fresh prefill, the metric
    samples the gateway acceptance reads.  (b) The same in bf16 on
    contiguous KV: exactly once, every greedy stream within TF_MARGIN
    teacher-forced; the byte-equal count against one bf16 contiguous
    engine printed.  (c) Two-role pool in f32: one paged prefill replica
    and two paged decode replicas behind ``DisaggRouter``,
    ``auto_replace=False``: exactly once, byte-equal to (a)'s oracle,
    24 migrations and ``tpu_gateway_kv_migrations_total`` 24, no
    ``prefill*`` label on a decode replica and no ``decode_*`` on the
    prefill replica, every request finished on a decode replica.  (d)
    The prefill replica downed after its first export wave: exactly
    once, the decode replicas prefill locally, byte-equal.  (e) The
    probes in bf16 at the 154M: ``gateway_probe`` (goodput, SLO
    attainment, queue waits; its accounting gated) and
    ``disagg_probe`` (TTFT unified against split, migration ms and
    bytes; its byte-equality printed: the unified pool's padded fill
    groups and the split pool's [1, L] exports round apart in bf16),
    then ``disagg_probe`` in f32 with its byte-equality gated.  (f)
    Same-card migration costs of
    a bf16 [1, 2048] cache and a bf16 96-token paged slab.  Returns the
    phase's K1 and K2 launches."""
    from k8s_dra_driver_tpu_torch.gateway import (FleetGateway,
                                                  ReplicaManager,
                                                  gateway_probe)
    from k8s_dra_driver_tpu_torch.gateway.replica import ROLE_DECODE
    from k8s_dra_driver_tpu_torch.models.serving import ServingEngine
    from k8s_dra_driver_tpu_torch.serving_disagg import (
        DisaggReplicaManager, DisaggRouter, KVMigrator, disagg_probe)
    t_phase = time.perf_counter()
    total = {"flash_fwd": 0, "flash_fwd_tc": 0, "paged_decode": 0}

    def add(counts):
        for k in total:
            total[k] += counts[k]

    f32 = map_params(params, lambda t: t.float())
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)

    def f32_paged(name=None):
        return ServingEngine(f32, cfg32, slots=8, top_k=50,
                             kv_layout="paged")

    def bf16_contiguous(name=None):
        return ServingEngine(params, cfg, slots=8, top_k=50, prefix_cache=4)

    oracle32, counts, _, _ = drain(ServingEngine, f32, cfg32, reqs, fa, pa,
                                   "fleet oracle f32 paged", top_k=50,
                                   kv_layout="paged")
    add(counts)
    oracle16, counts, _, _ = drain(ServingEngine, params, cfg, reqs, fa, pa,
                                   "fleet oracle bf16 contiguous", top_k=50,
                                   prefix_cache=4)
    add(counts)

    # (a) and (b): unified pools, r0 downed after its first wave
    for label, factory, dtype_cfg in (("(a) f32 paged", f32_paged, cfg32),
                                      ("(b) bf16 contiguous",
                                       bf16_contiguous, cfg)):
        unhealthy: dict = {}
        mgr = ReplicaManager(factory, replicas=2,
                             health_source=lambda u=unhealthy: u,
                             chip_of=lambda name: name)
        gw = FleetGateway(mgr, queue_capacity=64)
        counts, labels, wall = fleet_drive(
            gw, reqs, fa, pa,
            after_first=lambda u=unhealthy: u.update(
                r0="downed by the health signal"))
        add(counts)
        require_fwd_route(fa, f"fleet {label}",
                          dtype_cfg.dtype == torch.bfloat16)
        requeued = fleet_exactly_once(gw, reqs, label)
        st = gw.stats()
        if st["replicas"]["dead"] != 1 or st["replicas"]["ready"] != 2:
            fail(f"fleet {label}: replicas {st['replicas']}, expected 1 "
                 f"dead and 2 ready")
        text = gw.metrics.render().decode()
        drains = metric_value(text, r"^tpu_gateway_drains_total (\S+)$")
        n_requeued = metric_value(text,
                                  r"^tpu_gateway_requeued_total (\S+)$")
        waits = metric_value(
            text, r"^tpu_gateway_queue_wait_seconds_count (\S+)$")
        ttfts = metric_value(text, r"^tpu_gateway_ttft_seconds_count (\S+)$")
        if (drains != 1 or requeued < 1 or n_requeued != requeued
                or waits != len(reqs) + requeued or ttfts != len(reqs)):
            fail(f"fleet {label}: drains {drains}, requeued {n_requeued} "
                 f"(outcomes {requeued}), queue waits {waits}, TTFTs "
                 f"{ttfts} for {len(reqs)} requests")
        gen = sum(len(f.tokens) - f.n_prompt for f in gw.results.values())
        if dtype_cfg is cfg32:
            steps = fleet_kernels(cfg, counts, labels, label, ("prefill",))
            equal = fleet_byte_equal(gw, oracle32, label, gate=True)
            check = (f"{equal}/{len(reqs)} streams = the f32 paged oracle "
                     f"(gated); K2 {counts['paged_decode']} = "
                     f"{cfg.n_layers} x {steps} paged steps, K1 "
                     f"{counts['flash_fwd']} = {cfg.n_layers} x "
                     f"{labels.get('prefill', 0)} prefills (gated)")
        else:
            worst = teacher_forced(params, cfg, list(gw.results.values()),
                                   reqs)
            equal = fleet_byte_equal(gw, oracle16, label, gate=False)
            check = (f"teacher-forced worst gap {worst:.4f} <= {TF_MARGIN} "
                     f"(gated); {equal}/{len(reqs)} streams = the bf16 "
                     f"contiguous oracle (counted); K1 {counts['flash_fwd']}")
        print(f"fleet {label} ({card_line()}): exactly once {len(reqs)}/"
              f"{len(reqs)}, 1 drain, {requeued} requeued, replicas "
              f"{st['replicas']['ready']} ready + {st['replicas']['dead']} "
              f"dead; {gen} tokens in {1e3 * wall:.1f} ms = "
              f"{gen / wall:.1f} tokens/s over {st['steps']} pump steps; "
              f"{check}", flush=True)
        del gw, mgr

    # (c) and (d): the two-role pool, f32 paged, then its prefill kill
    for label, kill in (("(c) two-role f32", False),
                        ("(d) prefill downed f32", True)):
        unhealthy = {}
        mgr = DisaggReplicaManager(f32_paged, prefill_replicas=1,
                                   decode_replicas=2, depth_bound=8,
                                   health_source=lambda u=unhealthy: u,
                                   chip_of=lambda name: name)
        gw = FleetGateway(mgr, router=DisaggRouter(mgr.index),
                          queue_capacity=64, auto_replace=False)
        counts, labels, wall = fleet_drive(
            gw, reqs, fa, pa,
            after_first=(lambda u=unhealthy: u.update(
                p0="downed by the health signal")) if kill else None)
        add(counts)
        require_fwd_route(fa, f"fleet {label}", False)
        requeued = fleet_exactly_once(gw, reqs, label)
        steps = fleet_kernels(cfg, counts, labels, label, ("prefill",))
        equal = fleet_byte_equal(gw, oracle32, label, gate=True)
        per = gw.stats()["per_replica_dispatches"]
        by_role = {r.name: r.role for r in mgr.replicas}
        decode = {n for n, role in by_role.items() if role == ROLE_DECODE}
        local = 0
        for name, role in by_role.items():
            lbls = per.get(name, {}).get("by_label", {})
            bad = "prefill" if role == ROLE_DECODE else "decode_"
            hits = [k for k in lbls if k.startswith(bad)]
            if role == ROLE_DECODE:
                local += sum(lbls[k] for k in hits)
            if hits and not (kill and role == ROLE_DECODE):
                fail(f"fleet {label}: replica {name} ({role}) launched "
                     f"{hits}")
        if {g.replica for g in gw.outcomes.values()} - decode:
            fail(f"fleet {label}: a request finished off the decode "
                 f"replicas")
        mig = mgr.migration_stats()
        text = gw.metrics.render().decode()
        migrations = metric_value(
            text, r"^tpu_gateway_kv_migrations_total (\S+)$")
        if kill:
            drains = metric_value(text, r"^tpu_gateway_drains_total (\S+)$")
            if drains != 1 or requeued < 1 or local <= 0:
                fail(f"fleet {label}: drains {drains}, requeued {requeued}, "
                     f"decode-side prefills {local}")
        elif mig["migrations"] != len(reqs) or migrations != len(reqs):
            fail(f"fleet {label}: {mig['migrations']} migrations "
                 f"({migrations} in the metrics), expected {len(reqs)}")
        gen = sum(len(f.tokens) - f.n_prompt for f in gw.results.values())
        mean_ms = (1e3 * mig["wall_s"] / mig["migrations"]
                   if mig["migrations"] else 0.0)
        print(f"fleet {label} ({card_line()}): exactly once {len(reqs)}/"
              f"{len(reqs)}, {equal}/{len(reqs)} streams = the f32 paged "
              f"oracle (gated), {requeued} requeued, decode-side prefills "
              f"{local}; {mig['migrations']} migrations of "
              f"{mig['bytes_moved']} bytes ({mean_ms:.3f} ms mean, "
              f"{mig['tokens_moved']} tokens); K2 {counts['paged_decode']} "
              f"= {cfg.n_layers} x {steps} paged steps, K1 "
              f"{counts['flash_fwd']}; {gen} tokens in {1e3 * wall:.1f} ms "
              f"= {gen / wall:.1f} tokens/s; role split held", flush=True)
        del gw, mgr

    # (e) the probes at the 154M in bf16, with their JAX traffic defaults
    probe = gateway_probe(cfg=cfg, params=params)
    print(f"fleet gateway probe ({card_line()}): {json.dumps(probe)}",
          flush=True)
    if not probe["valid"]:
        fail("fleet gateway probe: a request went unaccounted")
    # the unified pool fills padded groups, the split pool [1, L]
    # exports: bf16 products of other row counts round apart, so the
    # probe's byte-equality is printed in bf16 and gated in f32
    for p, c in ((params, cfg), (f32, cfg32)):
        probe = disagg_probe(cfg=c, params=p)
        print(f"fleet disagg probe {str(c.dtype)[6:]} ({card_line()}): "
              f"{json.dumps(probe)}", flush=True)
        if c is cfg32 and not probe["byte_equal"]:
            fail("fleet disagg probe in f32: split streams differ from "
                 "the unified pool's")

    # (f) same-card migration costs in bf16: a [1, 2048] cache, a slab
    mig = KVMigrator()
    prompt96 = reqs[0].prompt
    costs = {}
    for name, kw in (("[1, 2048] cache", {}),
                     ("96-token paged slab", {"kv_layout": "paged"})):
        eng = ServingEngine(params, cfg, slots=8, top_k=50, **kw)
        blk = eng.prefill_export(type(reqs[0])(uid="m", prompt=prompt96,
                                               max_new=1))
        costs[name] = migrate_cost(mig, blk.kv)
        del eng, blk
    print(f"fleet migrate ({card_line()}, {FLEET_MIGRATE_REPS} same-card "
          f"copies into fresh storage each): {json.dumps(costs)}",
          flush=True)
    print(f"fleet phase wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return total


#: the process fleet (phase_procfleet): pump processes of the 154M in f32
PROC_WORKERS = 3
#: s8_r24 requests whose KV blocks cross between two pump processes
#: (r3 is sampled)
PROC_HANDOFFS = 4
#: the bf16 block the conductor round-trips through the codec: a
#: [1, PROC_CODEC_SEQ] cache
PROC_CODEC_SEQ = 1024
#: pump widths of the multi-process scaling probe
PROC_PROBE_WIDTHS = (1, 2, 4)


def proc_engine_cfg(cfg) -> dict:
    """The pumps' ``--engine-cfg``: the 154M's fields, in float32."""
    return {f: getattr(cfg, f) for f in (
        "vocab", "d_model", "n_layers", "n_heads", "n_kv_heads", "d_head",
        "d_ff", "max_seq")} | {"dtype": "float32"}


def proc_kernel_counts(gw, cfg, label: str, gate: bool) -> dict:
    """Every live pump's K1/K2 counters (``op_stats``); with ``gate``,
    fail unless each pump launched K1 a positive multiple of n_layers
    times, none on the tensor-core route (f32) and no K2 (contiguous).
    Returns the counters summed."""
    total = {"flash_fwd": 0, "flash_fwd_tc": 0, "paged_decode": 0}
    for h in gw.handles:
        if not h.live:
            continue
        k = gw._rpc(h, "stats")["kernel_launches"]
        if gate and (k["flash_fwd"] <= 0 or k["flash_fwd"] % cfg.n_layers
                     or k["flash_fwd_tc"] or k["paged_decode"]):
            fail(f"procfleet {label}: pump {h.name} reported {k}, expected "
                 f"K1 a positive multiple of {cfg.n_layers}, all on the "
                 f"f32 route, and no K2")
        for n in total:
            total[n] += k[n]
    return total


def phase_procfleet(params, cfg, reqs, fa, pa) -> dict:
    """The multi-process gateway on the card: pump processes, each with
    its own CUDA context and its own 154M replica, behind the conductor
    ``ProcessGateway``; s8_r24 in FLEET_BURSTS bursts.

    (a) f32 pool through a kill: PROC_WORKERS pumps of one 8-slot f32
    contiguous replica each (``tiny_model`` of the 154M's fields in
    float32), the pump holding r0 SIGKILLed by the fault plan at the
    cycle after the first burst's dispatch.  Gated: every uid finished
    exactly once and none refused; the journal's replay without
    conflicts or corrupt records; one pump death and at least one
    outcome requeued; every stream byte-equal to one f32 contiguous
    engine of 8 slots in this process, built by the same ``tiny_model``
    and draining s8_r24; each survivor's K1 launches a positive multiple
    of n_layers, on the f32 route.  (b) The KV handoff across two
    surviving pumps: PROC_HANDOFFS requests (one sampled) exported on one
    (``kv_export``: prefill, then the wire codec) and adopted on the
    other (``kv_adopt``); gated: the adopted streams equal (a)'s oracle;
    printed: frame bytes and the export, encode, pipe, decode, adopt and
    generation ms.  (c) The bf16 codec in this process: a bf16 [1,
    PROC_CODEC_SEQ] block of the 154M (``prefill_export``) through
    ``encode_kv_block``, ``json.dumps`` / ``loads`` and
    ``decode_kv_block``; gated: every leaf bit-equal, the adopted copy's
    tokens equal to the exported block's own; printed: frame MB, the
    encode, dumps, loads and decode ms beside a same-card copy of the
    same block (``KVMigrator``).  (d) ``multiproc_probe`` with null
    engines at PROC_PROBE_WIDTHS pumps (each pump opens the card):
    ``scaling_x``, the host's CPUs, wall admissions/s; not gated.
    Returns the K1/K2 launches: this process's (the oracle drain and
    (c)) plus the surviving pumps' (a SIGKILLed pump's are lost)."""
    from k8s_dra_driver_tpu_torch.cluster.faults import (PUMP_KIND,
                                                         PUMP_VERB,
                                                         FaultPlan,
                                                         FaultRule)
    from k8s_dra_driver_tpu_torch.gateway.procprobe import multiproc_probe
    from k8s_dra_driver_tpu_torch.gateway.procpump import (ProcessGateway,
                                                           tiny_model)
    from k8s_dra_driver_tpu_torch.gateway.wire import encode_request
    from k8s_dra_driver_tpu_torch.models.serving import ServingEngine
    from k8s_dra_driver_tpu_torch.serving_disagg import KVMigrator
    from k8s_dra_driver_tpu_torch.serving_disagg.wirekv import (
        decode_kv_block, encode_kv_block, frame_bytes)
    t_phase = time.perf_counter()
    total = {"flash_fwd": 0, "flash_fwd_tc": 0, "paged_decode": 0}

    def add(counts):
        for k in total:
            total[k] += counts[k]

    engine_cfg = proc_engine_cfg(cfg)
    cfg32, params32 = tiny_model(engine_cfg, "cuda")
    oracle, counts, _, _ = drain(ServingEngine, params32, cfg32, reqs, fa,
                                 pa, "procfleet oracle f32 contiguous")
    add(counts)
    by_uid = {f.uid: f.tokens for f in oracle}
    del oracle, params32

    # (a) the pool, one pump SIGKILLed after the first burst's dispatch
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        gw = ProcessGateway(td, workers=PROC_WORKERS, engine="tiny",
                            engine_cfg=engine_cfg, replicas=1, slots=8,
                            pump_plan=FaultPlan(), device="cuda")
        t_up = time.perf_counter() - t0
        try:
            victim = f"pump{gw._shard(reqs[0].prompt)}"
            # membership is checked at the start of each cycle: the
            # first passes (the burst dispatches), the second kills
            gw.pump_plan.arm(FaultRule(verb=PUMP_VERB, kind=PUMP_KIND,
                                       name=victim, skip=1, times=1,
                                       error="crash"))
            n = len(reqs) // FLEET_BURSTS
            t0 = time.perf_counter()
            for i in range(FLEET_BURSTS):
                for r in reqs[i * n:(i + 1) * n]:
                    g = gw.submit(r, slo_s=FLEET_SLO_S)
                    if g.status != "queued":
                        fail(f"procfleet (a): {r.uid} refused at the door "
                             f"({g.status})")
                gw.step()
            gw.run_until_idle()
            wall = time.perf_counter() - t0
            uids = {r.uid for r in reqs}
            statuses = {g.status for g in gw.outcomes.values()}
            if (gw.refused or set(gw.outcomes) != uids
                    or set(gw.results) != uids or statuses != {"finished"}):
                fail(f"procfleet (a): {len(gw.outcomes)} outcomes "
                     f"({statuses}), {len(gw.refused)} refusals for "
                     f"{len(uids)} requests")
            view = gw.store.replay()
            st = gw.stats()
            requeued = sum(g.requeues > 0 for g in gw.outcomes.values())
            if view.conflicts or view.corrupt or set(view.terminals) != uids:
                fail(f"procfleet (a): journal replay holds "
                     f"{len(view.terminals)} terminals, conflicts "
                     f"{view.conflicts}, corrupt {view.corrupt}")
            if st["pump_deaths"] != 1 or requeued < 1:
                fail(f"procfleet (a): {st['pump_deaths']} pump deaths, "
                     f"{requeued} requeued outcomes")
            equal = sum(np.array_equal(f.tokens, by_uid[u])
                        for u, f in gw.results.items())
            if equal != len(reqs):
                fail(f"procfleet (a): {len(reqs) - equal} streams differ "
                     f"from the single-engine oracle's")
            k_a = proc_kernel_counts(gw, cfg, "(a)", gate=True)
            gen = sum(len(f.tokens) - f.n_prompt
                      for f in gw.results.values())
            print(f"procfleet (a) f32 ({card_line()}): {PROC_WORKERS} pumps "
                  f"up in {t_up:.1f} s; {victim} SIGKILLed after the first "
                  f"burst; exactly once {len(reqs)}/{len(reqs)}, journal "
                  f"{len(view.terminals)} terminals (conflicts 0, corrupt "
                  f"0, torn {view.torn}, duplicates {view.duplicates}), "
                  f"{requeued} requeued, adopted from the journal "
                  f"{st['adopted_from_journal']}, steals {st['steals']}; "
                  f"{equal}/{len(reqs)} streams = the f32 oracle (gated); "
                  f"{gen} tokens in {1e3 * wall:.1f} ms = "
                  f"{gen / wall:.1f} tokens/s over {st['steps']} conductor "
                  f"cycles; survivors' K1 {k_a['flash_fwd']} (each a "
                  f"multiple of {cfg.n_layers}, f32 route)", flush=True)

            # (b) the handoff: export on one survivor, adopt on the other
            src, dst = [h for h in gw.handles if h.live]
            for r in reqs[:PROC_HANDOFFS]:
                t0 = time.perf_counter()
                exp = gw._rpc(src, "kv_export", req=encode_request(r))
                t1 = time.perf_counter()
                got = gw._rpc(dst, "kv_adopt", block=exp["block"])
                t2 = time.perf_counter()
                if not np.array_equal(np.asarray(got["tokens"], np.int32),
                                      by_uid[r.uid]):
                    fail(f"procfleet (b): {r.uid} adopted across pumps "
                         f"differs from the oracle's stream")
                ms_e, ms_a = exp["ms"], got["ms"]
                pipe_out = 1e3 * (t1 - t0) - ms_e["export"] - ms_e["encode"]
                pipe_in = (1e3 * (t2 - t1) - ms_a["decode"] - ms_a["adopt"]
                           - ms_a["generate"])
                print(f"procfleet (b) {r.uid} "
                      f"({'sampled' if r.temperature > 0 else 'greedy'}, "
                      f"{card_line()}): {src.name} -> {dst.name}, frame "
                      f"{frame_bytes(exp['block'])} bytes; export "
                      f"{ms_e['export']:.2f} ms, encode {ms_e['encode']:.2f}, "
                      f"pipe out {pipe_out:.2f}, pipe in {pipe_in:.2f}, "
                      f"decode onto the card {ms_a['decode']:.2f}, adopt "
                      f"{ms_a['adopt']:.2f}, generate {ms_a['generate']:.2f}; "
                      f"stream = the oracle's (gated)", flush=True)
            add(proc_kernel_counts(gw, cfg, "(b)", gate=False))
        finally:
            gw.close()

    # (c) the bf16 codec in this process: encode, JSON, decode
    eng = ServingEngine(params, cfg, slots=8, max_seq=PROC_CODEC_SEQ)
    req = type(reqs[0])(uid="codec", prompt=reqs[0].prompt, max_new=48)
    torch.cuda.synchronize()
    zero_serving_counts(fa, pa)
    blk = eng.prefill_export(req)
    torch.cuda.synchronize()
    add(kernel_snapshot(fa, pa))
    require_fwd_route(fa, "procfleet (c) export", True)
    t0 = time.perf_counter()
    enc = encode_kv_block(blk)
    t1 = time.perf_counter()
    text = json.dumps(enc)
    t2 = time.perf_counter()
    back = json.loads(text)
    t3 = time.perf_counter()
    got = decode_kv_block(back, dest="cuda")
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    leaves = list(zip(got.kv.tensors(), blk.kv.tensors()))
    if not all(a.dtype == b.dtype == torch.bfloat16
               and a.device == b.device and a.data_ptr() != b.data_ptr()
               and torch.equal(a.view(torch.int16), b.view(torch.int16))
               for a, b in leaves):
        fail("procfleet (c): a decoded bf16 leaf differs from the "
             "exported one (or shares its storage)")
    toks = []
    for b in (blk, got):
        eng.adopt_block(b)
        toks.append(eng.run()[0].tokens)
    if not np.array_equal(toks[0], toks[1]):
        fail("procfleet (c): the decoded block's stream differs from the "
             "exported block's")
    copy = migrate_cost(KVMigrator(), blk.kv)
    print(f"procfleet (c) bf16 codec ({card_line()}): [1, "
          f"{PROC_CODEC_SEQ}] block, {len(leaves)} leaves bit-equal, "
          f"stream equal (gated); frame {len(text) / 1e6:.3f} MB "
          f"({frame_bytes(enc)} payload bytes, {copy['bytes']} raw); "
          f"encode {1e3 * (t1 - t0):.2f} ms, json.dumps "
          f"{1e3 * (t2 - t1):.2f}, json.loads {1e3 * (t3 - t2):.2f}, "
          f"decode onto the card {1e3 * (t4 - t3):.2f}; a same-card copy "
          f"of the same block {copy['mean_ms']:.3f} ms (best "
          f"{copy['best_ms']:.3f})", flush=True)
    del eng, blk, got, enc, back, text

    # (d) the scaling probe, null engines, every pump on the card
    probe = multiproc_probe(pump_counts=PROC_PROBE_WIDTHS, device="cuda")
    walls = {lv["pumps"]: lv["admissions_per_wall_s"]
             for lv in probe["levels"]}
    print(f"procfleet (d) multiproc probe ({card_line()}): scaling_x "
          f"{probe['scaling_x']} (CPU-time-normalized, widths "
          f"{probe['pump_counts']}), host_cpus {probe['host_cpus']}, "
          f"wall admissions/s by width {walls}, outcome counts equal "
          f"{probe['outcome_counts_equal']}, fsync p50 "
          f"{probe['outcome_fsync_ms']} ms (not gated)", flush=True)
    print(f"procfleet phase wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return total


#: the observatory probe's request counts (bench.py TINY_OBS_KWARGS)
OBS_PROBE_KWARGS = dict(n_requests=96, reps=2, pumps=2, replicas=2, slots=4,
                        queue_capacity=48)
#: allowed gap between the allocator's rise over an engine build and the
#: MemWatch ledger of that engine (phase_observability (a))
LEDGER_TOL = 0.05
#: the control loop's pump-step clock: fake seconds a cycle
CTL_DT = 0.5
#: the burst's deadline in fake seconds: every request is dispatched
#: within it (three replicas of 8 slots take s8_r24 in three cycles),
#: none can finish within it (48 tokens take 48 cycles)
CTL_TIGHT_SLO_S = 10.0
#: the cycles one control-loop scenario may take before it fails
CTL_MAX_CYCLES = 400
#: rank and resident slots of the low tenant's adapter pools
#: (phase_fleet_control (b))
MT_RANK = 16
MT_ADAPTERS = 3


def allocated() -> int:
    """Live tensor bytes of the card's caching allocator, after a
    synchronize."""
    torch.cuda.synchronize()
    return int(torch.cuda.memory_stats()["allocated_bytes.all.current"])


def param_tensors(params) -> list:
    return [params["embed"], params["unembed"], params["ln_f"]] + [
        t for layer in params["layers"] for t in layer.values()]


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


#: the dispatch labels of the fills that run K1: a fresh paged fill
#: (``prefill``) and a contiguous engine's padded fresh group
#: (``prefill_adopt_rows``); suffix fills over cached rows read the
#: cache without K1
K1_FILLS = ("prefill", "prefill_adopt_rows")


def kv_kernel_counts(cfg, counts, labels, label) -> str:
    """``fleet_kernels`` over K1_FILLS; returns the line that says what
    it held."""
    steps = fleet_kernels(cfg, counts, labels, label, K1_FILLS)
    fills = sum(labels.get(k, 0) for k in K1_FILLS)
    return (f"K2 {counts['paged_decode']} = {cfg.n_layers} x {steps} paged "
            f"steps, K1 {counts['flash_fwd']} = {cfg.n_layers} x {fills} "
            f"fresh fills (gated)")


def phase_observability(cfg, reqs, fa, pa) -> dict:
    """Serving observability on the card at the 154M, params made here
    from generator seed 0.

    (a) Memory ledger: the allocator's live bytes
    (``allocated_bytes.all.current``) read before and after building a
    bf16 paged engine of 8 slots, then ``MemWatch().account_engine``.
    Gated: ``model_params`` + ``paged_kv_pool`` equal a ``numel x
    element_size`` sum over the engine's parameter and pool tensors,
    exactly; the allocator's rise within LEDGER_TOL of the ledger total
    (both printed, and the ratio); the source ``"device"``.  Then s8_r24
    drained through that engine: every stream within TF_MARGIN
    teacher-forced, K2 n_layers a paged step and K1 n_layers a fresh
    prefill, the ledger unchanged; what the allocator holds beyond the
    ledger after the drain printed, with the engine's device mirrors
    named.  (b) ``observatory_probe`` at bench.py's TINY_OBS_KWARGS
    request counts with the 154M in bf16 as its accounted engine: gated
    ``valid``, source ``"device"``, the merged digest count equal to the
    per-pump counts' sum; printed ``digest_overhead_x``.  (c)
    ``paged_kv_probe`` at the 154M in f32 (gated: ``byte_equal``, CoW
    share above 0, no allocation failure, paged concurrency above
    contiguous; K2 n_layers a paged step and K1 n_layers a fresh prefill)
    and in bf16 (printed).  Returns the phase's K1 and K2 launches."""
    from k8s_dra_driver_tpu_torch.gateway.obsprobe import observatory_probe
    from k8s_dra_driver_tpu_torch.models.serving import ServingEngine
    from k8s_dra_driver_tpu_torch.models.transformer import init_params
    from k8s_dra_driver_tpu_torch.serving_kv import probe as kv_probe
    from k8s_dra_driver_tpu_torch.utils import dispatch
    from k8s_dra_driver_tpu_torch.utils.memwatch import MemWatch, tree_nbytes
    t_phase = time.perf_counter()
    total = {"flash_fwd": 0, "flash_fwd_tc": 0, "paged_decode": 0}

    def add(counts):
        for k in total:
            total[k] += counts[k]

    # (a) the ledger against the allocator: freed blocks cached by
    # earlier phases are returned first, so the build's tensors get
    # blocks of their own (512-byte rounding) instead of reusing larger
    # cached ones whole
    gc.collect()
    torch.cuda.empty_cache()
    # K2's split-merge workspace and arrival counters, kept per stream
    # and grown on demand: what the drain adds there is no engine's
    k2_before = sum(nbytes(pair) for pair in pa._buffers.values())
    before = allocated()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    eng = ServingEngine(params, cfg, slots=8, top_k=50, kv_layout="paged")
    after = allocated()
    mw = MemWatch()
    mw.account_engine(eng, "r0")
    snap = mw.snapshot()
    comps = dict(snap["components"])
    want = {"model_params/r0": nbytes(param_tensors(params)),
            "paged_kv_pool/r0": nbytes(eng.pool.tensors())}
    if comps != want:
        fail(f"obs (a): ledger {comps} != the tensors' bytes {want}")
    if snap["device_source"] != "device":
        fail(f"obs (a): MemWatch read its {snap['device_source']!r}, not "
             f"the card's allocator")
    ledger = snap["accounted_bytes"]
    rise = after - before
    ratio = rise / ledger
    if abs(ratio - 1.0) > LEDGER_TOL:
        fail(f"obs (a): the allocator rose {rise} bytes over the engine "
             f"build, the ledger holds {ledger} (ratio {ratio:.6f}, "
             f"allowed 1 +- {LEDGER_TOL})")
    print(f"obs (a) memory ledger ({card_line()}): 154M bf16 paged engine, "
          f"model_params {want['model_params/r0']} + paged_kv_pool "
          f"{want['paged_kv_pool/r0']} = {ledger} bytes (= numel x "
          f"element_size, gated); allocator rise {rise} bytes, ratio "
          f"{ratio:.6f} (uncapped; within {LEDGER_TOL}, gated); "
          f"accounted_frac of the whole allocator "
          f"{snap['accounted_frac']:.4f} over "
          f"{snap['device_bytes_in_use']} bytes (source "
          f"{snap['device_source']})", flush=True)
    for r in reqs:
        eng.submit(r)
    zero_serving_counts(fa, pa)
    t0 = time.perf_counter()
    with dispatch.track() as t:
        done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernel_snapshot(fa, pa)
    add(counts)
    require_fwd_route(fa, "obs (a)", True)
    if len(done) != len(reqs):
        fail(f"obs (a): {len(done)} of {len(reqs)} requests finished")
    worst = teacher_forced(params, cfg, done, reqs)
    check = kv_kernel_counts(cfg, counts, t.by_label, "obs (a)")
    again = MemWatch()
    again.account_engine(eng, "r0")
    if again.snapshot()["components"] != comps:
        fail(f"obs (a): the ledger moved over the drain: "
             f"{again.snapshot()['components']} != {comps}")
    held = allocated() - before
    mirrors = {name: tree_nbytes(getattr(eng, name, None))
               for name in ("_table_dev", "_kv_dense_memo", "_lora_dev")}
    k2_grown = sum(nbytes(pair) for pair in pa._buffers.values()) - k2_before
    print(f"obs (a) after draining s8_r24 ({wall:.3f} s): ledger unchanged "
          f"(gated); teacher-forced worst gap {worst:.4f} <= {TF_MARGIN} "
          f"(gated); {check}; the allocator holds {held} bytes over the "
          f"pre-build reading, {held - ledger} beyond the ledger: K2's "
          f"workspace and counters grew {k2_grown}, the engine's device "
          f"mirrors {mirrors}, the rest "
          f"{held - ledger - k2_grown - sum(mirrors.values())} (no engine "
          f"tensor: a matrix library's workspace made at this process's "
          f"first product and the like)", flush=True)
    del eng, params, done, mw, again

    # (b) the observatory probe: the 154M as its accounted engine, then
    # its reference default (d_head 8, bf16)
    for engine, pcfg in (("the 154M", cfg),
                         ("the reference default (d_head 8)", None)):
        probe = observatory_probe(**OBS_PROBE_KWARGS, cfg=pcfg,
                                  device="cuda")
        if not probe["valid"]:
            fail(f"obs (b): observatory_probe on {engine} not valid: "
                 f"{probe}")
        if probe["hbm_device_source"] != "device":
            fail(f"obs (b): the probe's ledger read "
                 f"{probe['hbm_device_source']}")
        if probe["merged_digest_count"] != sum(probe["per_pump_counts"]):
            fail(f"obs (b): merged count {probe['merged_digest_count']} != "
                 f"the per-pump counts {probe['per_pump_counts']}")
        print(f"obs (b) observatory probe ({card_line()}): valid (gated), "
              f"digest_overhead_x {probe['digest_overhead_x']} (ratios "
              f"{probe['digest_ratios']}), merged count "
              f"{probe['merged_digest_count']} = sum of per-pump "
              f"{probe['per_pump_counts']} (gated), merged quantiles "
              f"{probe['merged_quantiles']}; {engine} engine's ledger "
              f"{probe['hbm_accounted_bytes']} bytes, accounted_frac "
              f"{probe['hbm_accounted_frac']} of {probe['hbm_device_bytes']} "
              f"allocated (source {probe['hbm_device_source']}, gated), "
              f"components {probe['hbm_components']}", flush=True)

    # (c) the paged-KV probe, f32 (gated) then bf16 (printed) at the
    # 154M, then at its reference default (8 heads of 16 over 4, f32,
    # gated)
    for dtype, name, pcfg in (
            (torch.float32, "f32",
             dataclasses.replace(cfg, dtype=torch.float32)),
            (torch.bfloat16, "bf16",
             dataclasses.replace(cfg, dtype=torch.bfloat16)),
            (torch.float32, "at its reference default (D=16) f32", None)):
        zero_serving_counts(fa, pa)
        # the concurrency wave's two drains (paged, then contiguous) are
        # the probe's first two pumps: keep them to count equal streams
        waves, pump = [], kv_probe._pump
        kv_probe._pump = lambda eng: waves.append(pump(eng)) or waves[-1]
        try:
            with dispatch.track() as t:
                out = kv_probe.paged_kv_probe(cfg=pcfg, device="cuda")
        finally:
            kv_probe._pump = pump
        torch.cuda.synchronize()
        paged_done, contig_done = waves[0][0], waves[1][0]
        equal = sum(np.array_equal(f.tokens, contig_done[u].tokens)
                    for u, f in paged_done.items())
        counts = kernel_snapshot(fa, pa)
        add(counts)
        require_fwd_route(fa, f"obs (c) {name}", dtype == torch.bfloat16)
        line = (f"obs (c) paged-KV probe {name} ({card_line()}): "
                f"pg_max_concurrent_x {out['pg_max_concurrent_x']} (paged "
                f"{out['paged_peak_active']} / contiguous "
                f"{out['contig_peak_active']} over {out['budget_rows']} "
                f"rows), pg_cow_shared_frac {out['pg_cow_shared_frac']}, "
                f"alloc_failures {out['alloc_failures']}, byte_equal "
                f"{out['byte_equal']} ({equal}/{len(paged_done)} wave "
                f"streams equal), pg_decode_tok_s_ratio "
                f"{out['pg_decode_tok_s_ratio']} (paged "
                f"{out['paged_tok_s']} / contiguous {out['contig_tok_s']} "
                f"tokens/s), wall {out['wall_s']} s")
        if dtype == torch.float32:
            # at its reference default the budget (96 rows) is tight by
            # design and the wave's allocations fail and preempt, in the
            # JAX probe too: there the reference's acceptance holds
            # (tests/test_bench_smoke.py), at the 154M none may fail
            roomy = out["alloc_failures"] == 0 or pcfg is None
            if not (out["byte_equal"] and out["pg_cow_shared_frac"] > 0
                    and roomy and out["pg_max_concurrent_x"] > 1
                    and out["paged_peak_active"]
                    > out["contig_peak_active"]):
                fail(f"obs (c): f32 probe gates failed: {out}")
            line += "; gates held; " + kv_kernel_counts(
                pcfg or kv_probe.probe_config(), counts, t.by_label,
                f"obs (c) {name}")
        else:
            line += f" (not gated); K1 {counts['flash_fwd']}, K2 " \
                    f"{counts['paged_decode']}"
        print(line, flush=True)
    print(f"obs phase wall {time.perf_counter() - t_phase:.1f} s", flush=True)
    return total


def control_loop(make_engine, waves, slo_s, fault=True):
    """The 1x1 fleet loop: ``FleetReconciler`` over a ``FleetGateway``
    of one replica at start (``auto_replace=False``), ``ChipLedger([0, 1,
    2, 3])`` as allocation labels (every replica lives on this card),
    ``health_source = ledger.current_unhealthy``, the injected clock
    driven as ``gw.step(); rec.tick()``, ``SloBurnEngine`` and
    ``MemWatch`` on the gateway, a ``Tracer`` wired through the pool.
    ``waves[0]`` is submitted at once under ``slo_s`` and pumped until
    the pool is back at one replica; then (``fault``) the last live
    replica's label is marked unhealthy, ``waves[1]`` submitted, and the
    label healed once the wave is dispatched elsewhere; then pumped
    until idle.  Returns (gateway, reconciler, tracer, record): per
    tick the ledger's owned labels against the live replicas' labels,
    per pump step MemWatch's units against the live replicas, the heals
    taken, the alerts and the burn engine."""
    from k8s_dra_driver_tpu_torch.cluster.bus import EventBus
    from k8s_dra_driver_tpu_torch.fleet import (ChipLedger, FleetPolicy,
                                                FleetReconciler, PolicyConfig)
    from k8s_dra_driver_tpu_torch.gateway import (FleetGateway, ReplicaManager,
                                                  SloBurnEngine)
    from k8s_dra_driver_tpu_torch.sim.clock import VirtualClock
    from k8s_dra_driver_tpu_torch.utils.memwatch import MemWatch
    from k8s_dra_driver_tpu_torch.utils.tracing import Tracer
    clock = VirtualClock()
    health: dict = {}
    ledger = ChipLedger([0, 1, 2, 3], health_source=lambda: dict(health))
    healed = []
    take = ledger.take_healed

    def take_healed():
        out = take()
        if out:
            healed.append(sorted(out))
        return out

    ledger.take_healed = take_healed
    mgr = ReplicaManager(make_engine, replicas=1,
                         health_source=ledger.current_unhealthy,
                         chip_of=lambda name: 3, depth_bound=8)
    bus = EventBus(seed=0)
    tracer = Tracer(bus=bus, clock=clock)
    mw = MemWatch()
    burn = SloBurnEngine()
    gw = FleetGateway(mgr, queue_capacity=64, clock=clock,
                      auto_replace=False, bus=bus, tracer=tracer, burn=burn,
                      memwatch=mw, tenant="serve")
    rec = FleetReconciler(gw, ledger=ledger, clock=clock, tracer=tracer,
                          policy=FleetPolicy(PolicyConfig(
                              queue_high=4, up_after=1, down_after=3,
                              min_replicas=1, max_replicas=3)))
    alerts = []
    bus.subscribe("alert", lambda ev: alerts.append(dict(ev.payload)))
    owners, units = [], []

    def live():
        return [r for r in mgr.replicas if r.state != "dead"]

    def cycle():
        gw.step()
        units.append((sorted({k.split("/")[1] for k in
                              mw.snapshot()["components"]}),
                      sorted(r.name for r in live())))
        rec.tick()
        owners.append((sorted(c for c, o in ledger.owners.items() if o),
                       sorted(r.chip for r in live())))
        clock.t += CTL_DT

    def pump_until(done):
        for _ in range(CTL_MAX_CYCLES):
            if done():
                return
            cycle()
        fail(f"control loop: not settled in {CTL_MAX_CYCLES} cycles "
             f"(events {rec.events})")

    def idle():
        return not gw.pending() and not any(r.in_flight for r in live())

    for r in waves[0]:
        g = gw.submit(r, slo_s=slo_s)
        if g.status != "queued":
            fail(f"control loop: {r.uid} refused at the door ({g.status})")
    pump_until(lambda: idle() and len(live()) == 1)
    if fault:
        sick = live()[-1]
        health[sick.chip] = "uncorrectable ECC (scripted)"
        for r in waves[1]:
            gw.submit(r, slo_s=600.0)
        # heal once the sick replica is reaped and the wave is placed
        # on the replica that took its place
        pump_until(lambda: sick not in mgr.replicas and not gw.pending()
                   and all(r.uid in gw.outcomes or any(
                       r.uid in x.in_flight for x in live())
                       for r in waves[1]))
        health.clear()
    pump_until(idle)
    for _ in range(2):
        cycle()             # the heal is taken on the next tick
    return gw, rec, tracer, dict(owners=owners, units=units, healed=healed,
                                 alerts=alerts, burn=burn, mw=mw)


def check_control_loop(gw, rec, record, reqs, label, n_replicas_max=3):
    """The 1x1 loop's gates (phase_fleet_control (a)); returns the
    events' kinds."""
    kinds = [k for _, k, _ in rec.events]
    if "scale_up" not in kinds or "scale_down" not in kinds:
        fail(f"{label}: no scale-up or no scale-down in {rec.events}")
    downs = [i["replica"] for _, k, i in rec.events if k == "scale_down"]
    retired = [i["replica"] for _, k, i in rec.events if k == "retired"]
    if sorted(downs) != sorted(retired):
        fail(f"{label}: drained {downs} but retired {retired}")
    reaped = [i for _, k, i in rec.events if k == "reap_dead"]
    if len(reaped) != 1:
        fail(f"{label}: {len(reaped)} replicas reaped, expected the sick "
             f"one once: {rec.events}")
    if record["healed"] != [[reaped[0]["chip"]]]:
        fail(f"{label}: heals taken {record['healed']}, expected "
             f"[[{reaped[0]['chip']}]] once")
    bad = [(t, o) for t, o in enumerate(record["owners"]) if o[0] != o[1]]
    if bad:
        fail(f"{label}: ledger owners != live replicas' labels at ticks "
             f"{bad[:3]}")
    bad = [(t, u) for t, u in enumerate(record["units"]) if u[0] != u[1]]
    if bad:
        fail(f"{label}: MemWatch units != live replicas at steps {bad[:3]}")
    return kinds


def phase_fleet_control(cfg, reqs, fa, pa) -> dict:
    """The fleet control loop on the card at the 154M, params made here
    from generator seed 0.

    (a) ``FleetReconciler`` over a ``FleetGateway`` of 8-slot f32 paged
    engines (``control_loop``): the first 16 requests of s8_r24 as a
    burst under a CTL_TIGHT_SLO_S deadline, calm, then the last live
    replica's label marked unhealthy with the last 8 submitted, and
    healed.  Gated: every uid finished exactly once; every stream
    byte-equal to one f32 paged engine draining s8_r24; at least one
    scale-up and every scale-down drained then retired; the ledger's
    owned labels equal the live replicas' after every tick; the sick
    replica reaped once and the heal taken once; MemWatch's units equal
    the live replicas after every pump step; at least one burn-rate
    alert, and none in a control run of the same burst under a 600 s
    deadline; K2 n_layers a paged step and K1 n_layers a fresh prefill.
    Then: ``critical_path`` of every uid that was never requeued sums
    its parts to its wall within 1e-6 s; ``export_chrome`` twice is
    byte-equal; ``rec.serve_metrics`` serves ``tpu_fleet_ticks_total``,
    ``tpu_gateway_queue_depth`` and ``tpu_mem_accounted_frac`` on one GET
    of ``/metrics``.  The action timeline is printed.  (b)
    ``MultiTenantReconciler`` over two serving tenants of 8-slot bf16
    paged engines (``two_tenant_loop``): hi (priority 2, floor 1) bursts
    s8_r24 against lo (priority 1, floor 1, two
    replicas whose engines each carry an ``AdapterPool`` of MT_ADAPTERS
    cold rank-MT_RANK adapters, quota one slot).  Gated: every adapter
    eviction before any chip action; every reclaim taken from lo for hi,
    lo never below its floor; a grant to hi; a release in calm; every
    uid of both tenants finished exactly once; K2 n_layers a paged step
    and K1 n_layers a fresh prefill.  ``fairshare_error()`` printed.
    Returns the phase's K1 and K2 launches."""
    import urllib.request

    from k8s_dra_driver_tpu_torch.models.serving import ServingEngine
    from k8s_dra_driver_tpu_torch.models.transformer import init_params
    from k8s_dra_driver_tpu_torch.utils import dispatch
    from k8s_dra_driver_tpu_torch.utils.tracing import (critical_path,
                                                        export_chrome)
    t_phase = time.perf_counter()
    total = {"flash_fwd": 0, "flash_fwd_tc": 0, "paged_decode": 0}

    def add(counts):
        for k in total:
            total[k] += counts[k]

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = init_params(cfg32, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda")

    def f32_paged(name=None):
        return ServingEngine(params32, cfg32, slots=8, top_k=50,
                             kv_layout="paged")

    oracle, counts, _, _ = drain(ServingEngine, params32, cfg32, reqs, fa, pa,
                                 "control oracle f32 paged", top_k=50,
                                 kv_layout="paged")
    add(counts)
    waves = (reqs[:16], reqs[16:])

    # (a) the 1x1 loop, then its calm control run
    zero_serving_counts(fa, pa)
    t0 = time.perf_counter()
    with dispatch.track() as t:
        gw, rec, tracer, record = control_loop(f32_paged, waves,
                                               CTL_TIGHT_SLO_S)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernel_snapshot(fa, pa)
    add(counts)
    require_fwd_route(fa, "control (a)", False)
    fleet_exactly_once(gw, reqs, "control (a)")
    equal = fleet_byte_equal(gw, oracle, "control (a)", gate=True)
    kinds = check_control_loop(gw, rec, record, reqs, "control (a)")
    check = kv_kernel_counts(cfg, counts, t.by_label, "control (a)")
    if not record["alerts"]:
        fail("control (a): the burst under a tight deadline fired no "
             "burn-rate alert")
    timeline = [(t_, k, i.get("replica"), i.get("chip"))
                for t_, k, i in rec.events]
    print(f"control (a) 1x1 loop ({card_line()}): f32 paged, exactly once "
          f"{len(reqs)}/{len(reqs)}, {equal}/{len(reqs)} streams = the f32 "
          f"paged oracle (gated); {check}; {len(record['owners'])} ticks in "
          f"{wall:.3f} s wall; ledger owners = live replicas' labels every "
          f"tick, MemWatch units = live replicas every step, reaped once, "
          f"healed once {record['healed']} (gated); burn-rate alerts "
          f"{len(record['alerts'])} (first {record['alerts'][0]})",
          flush=True)
    print(f"control (a) action timeline (fake s, kind, replica, label): "
          f"{timeline}", flush=True)
    parts = ("queue_wait", "prefill", "migrate", "decode", "drain_gap")
    worst, longest = 0.0, None
    for uid, g in gw.outcomes.items():
        if g.requeues:
            continue
        cp = critical_path(tracer.spans, f"t-{uid}")
        if cp["spans"] < 2:
            fail(f"control (a): {uid} has {cp['spans']} spans")
        worst = max(worst, abs(sum(cp[p] for p in parts) - cp["total"]))
        if longest is None or cp["total"] > longest[1]["total"]:
            longest = (uid, cp)
    if worst > 1e-6:
        fail(f"control (a): a critical path's parts miss its wall by "
             f"{worst} s")
    first, second = export_chrome(tracer.spans), export_chrome(tracer.spans)
    if first != second:
        fail("control (a): two Chrome-trace exports differ")
    endpoint = rec.serve_metrics("127.0.0.1:0")
    try:
        with urllib.request.urlopen(f"http://{endpoint.address}/metrics",
                                    timeout=10) as resp:
            body = resp.read().decode()
    finally:
        endpoint.stop()
    for family in ("tpu_fleet_ticks_total", "tpu_gateway_queue_depth",
                   "tpu_mem_accounted_frac"):
        if f"# TYPE {family}" not in body:
            fail(f"control (a): /metrics lacks {family}")
    frac = metric_value(body, r"^tpu_mem_accounted_frac (\S+)$")
    print(f"control (a) spans: {len(tracer.spans)} (kept), critical path "
          f"parts = wall within {worst:.2e} s over every unrequeued uid "
          f"(gated), longest {longest[0]} {longest[1]}; export_chrome "
          f"{len(first)} bytes, twice equal (gated); /metrics {len(body)} "
          f"bytes with the fleet, gateway and MemWatch families (gated), "
          f"tpu_mem_accounted_frac {frac}", flush=True)
    del gw, rec, tracer, record, first, second, body

    zero_serving_counts(fa, pa)
    gw, rec, _, record = control_loop(f32_paged, waves, 600.0, fault=False)
    torch.cuda.synchronize()
    add(kernel_snapshot(fa, pa))
    if record["alerts"]:
        fail(f"control (a): the calm control run fired {record['alerts']}")
    print(f"control (a) calm control run: 600 s deadline, no burn-rate "
          f"alert (gated), {len(gw.outcomes)} outcomes, actions "
          f"{[k for _, k, _ in rec.events]}", flush=True)
    del gw, rec, record, params32, oracle

    # (b) two tenants
    zero_serving_counts(fa, pa)
    t0 = time.perf_counter()
    with dispatch.track() as t:
        out = two_tenant_loop(cfg, reqs)
    torch.cuda.synchronize()
    counts = kernel_snapshot(fa, pa)
    add(counts)
    require_fwd_route(fa, "control (b)", True)
    check = kv_kernel_counts(cfg, counts, t.by_label, "control (b)")
    print(f"control (b) two tenants ({card_line()}): bf16 paged, "
          f"{out['line']}; {check}; {time.perf_counter() - t0:.3f} s wall",
          flush=True)
    print(f"control (b) action timeline (fake s, kind, tenant, replica): "
          f"{out['timeline']}", flush=True)
    print(f"control phase wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return total


def two_tenant_loop(cfg, reqs):
    """``MultiTenantReconciler`` over two serving tenants on labels 0-3
    (``TopologyBinPacker`` of one-label domains): hi (priority 2, quota
    3, floor 1) with one replica on label 3, lo (priority 1, quota 3,
    floor 1, adapter quota one slot) with two on labels 0 and 1, each of
    lo's engines carrying its own ``AdapterPool`` of MT_ADAPTERS cold
    adapters of tenant lo.  hi takes ``reqs`` as a burst under
    ``burst_slo_s``, lo a third of them; pumped until both are idle and
    hi is back at its floor.  Fails on a broken gate; returns the
    printed line and the timeline."""
    from k8s_dra_driver_tpu_torch.fleet import (ChipLedger, MtConfig,
                                                MultiTenantReconciler,
                                                ServingTenant, TenantRegistry,
                                                TenantSpec, TopologyBinPacker)
    from k8s_dra_driver_tpu_torch.gateway import FleetGateway, ReplicaManager
    from k8s_dra_driver_tpu_torch.models.serving import Request, ServingEngine
    from k8s_dra_driver_tpu_torch.models.transformer import init_params
    from k8s_dra_driver_tpu_torch.serving_lora import (AdapterManifest,
                                                       AdapterPool,
                                                       make_adapter)
    from k8s_dra_driver_tpu_torch.sim.clock import VirtualClock
    clock = VirtualClock()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")

    def lo_pool():
        pool = AdapterPool(cfg, MT_RANK, n_resident=MT_ADAPTERS)
        for i in range(MT_ADAPTERS):
            name = f"lo{i}"
            pool.register(AdapterManifest(
                name, MT_RANK, tenant="lo",
                source=make_adapter(cfg, MT_RANK, seed=500 + i)))
            pool.release(pool.acquire(name))
        return pool

    chips = {"hi": {"r0": 3}, "lo": {"r0": 0, "r1": 1}}

    def gateway(tenant, n, pools):
        mgr = ReplicaManager(
            lambda name: ServingEngine(
                params, cfg, slots=8, top_k=50, kv_layout="paged",
                adapter_pool=lo_pool() if pools else None),
            replicas=n, chip_of=chips[tenant].get, depth_bound=8)
        return FleetGateway(mgr, queue_capacity=64, clock=clock,
                            auto_replace=False, tenant=tenant)

    gws = {"hi": gateway("hi", 1, False), "lo": gateway("lo", 2, True)}
    bytes_per_slot = gws["lo"].manager.replicas[0].engine \
        .adapter_pool.bytes_per_slot
    registry = TenantRegistry(capacity=4)
    registry.add(TenantSpec("hi", priority=2, quota=3, floor=1),
                 ServingTenant(gws["hi"]))
    registry.add(TenantSpec("lo", priority=1, quota=3, floor=1,
                            adapter_quota_bytes=bytes_per_slot),
                 ServingTenant(gws["lo"]))
    ledger = ChipLedger([0, 1, 2, 3])
    rec = MultiTenantReconciler(
        registry, ledger=ledger,
        packer=TopologyBinPacker(ledger, domain_size=1),
        config=MtConfig(queue_high=4, up_after=1, down_after=3),
        clock=clock)
    lo_reqs = [Request(uid=f"lo-{r.uid}", prompt=r.prompt, max_new=r.max_new,
                       temperature=r.temperature, seed=r.seed)
               for r in reqs[::3]]
    held, errs = [], []

    def idle(gw):
        return not gw.pending() and not any(
            r.in_flight for r in gw.manager.replicas)

    def pump_until(done):
        for _ in range(CTL_MAX_CYCLES):
            if done():
                return
            for gw in gws.values():
                gw.step()
            rec.tick()
            held.append({t: sorted(registry.workload(t).chips())
                         for t in gws})
            errs.append(rec.fairshare_error())
            clock.t += CTL_DT
        fail(f"control (b): not settled in {CTL_MAX_CYCLES} cycles "
             f"(events {rec.events})")

    for r in lo_reqs:
        gws["lo"].submit(r, slo_s=600.0)
    for r in reqs:
        gws["hi"].submit(r, slo_s=600.0)
    pump_until(lambda: all(idle(gw) for gw in gws.values())
               and len(held[-1]["hi"]) == 1)
    kinds = [(k, i.get("tenant"), i.get("beneficiary"))
             for _, k, i in rec.events]
    evicts = [n for n, (k, _, _) in enumerate(kinds) if k == "adapter_evict"]
    chip_acts = [n for n, (k, _, _) in enumerate(kinds)
                 if k in ("grant", "reclaim_drain", "reclaim_shrink",
                          "reclaim_park", "release")]
    if not evicts or not chip_acts or max(evicts) > min(chip_acts):
        fail(f"control (b): adapter evictions {evicts} must all come "
             f"before the first chip action {chip_acts[:1]}: {kinds}")
    reclaims = [x for x in kinds if x[0].startswith("reclaim")]
    if not reclaims or any(x[1:] != ("lo", "hi") for x in reclaims):
        fail(f"control (b): reclaims {reclaims}, expected from lo for hi")
    if ("grant", "hi", None) not in kinds or not any(
            k == "release" for k, _, _ in kinds):
        fail(f"control (b): no grant to hi or no calm release: {kinds}")
    if min(len(h["lo"]) for h in held) < 1:
        fail("control (b): lo fell below its floor of 1 label")
    for tenant, want in (("hi", reqs), ("lo", lo_reqs)):
        fleet_exactly_once(gws[tenant], want, f"control (b) {tenant}")
    evicted = sum(len(i.get("adapters", [])) for _, k, i in rec.events
                  if k == "adapter_evict")
    timeline = [(t_, k, i.get("tenant"), i.get("replica"))
                for t_, k, i in rec.events]
    line = (f"{evicted} adapters evicted before any chip action, reclaims "
            f"{len(reclaims)} all from lo for hi, lo held >= 1 label, a "
            f"grant and a release, exactly once hi {len(reqs)}/{len(reqs)} "
            f"and lo {len(lo_reqs)}/{len(lo_reqs)} (gated); peak hi labels "
            f"{max(len(h['hi']) for h in held)}; fairshare_error max "
            f"{max(errs):.4f}, last {errs[-1]:.4f} over {len(errs)} ticks")
    return {"line": line, "timeline": timeline}


def zero_counts(fa) -> None:
    fa.launches = fa.dq_launches = fa.dkv_launches = 0
    fa.tc_launches = fa.dq_tc_launches = fa.dkv_tc_launches = 0
    fa.block_launches = fa.block_tc_launches = 0


def flash_routes(fa) -> dict:
    """K1, K3 and K4 launches by route: tensor cores (bf16) and CUDA
    cores (f32)."""
    return {"flash_fwd_tc": fa.tc_launches,
            "flash_fwd_f32": fa.launches - fa.tc_launches,
            "flash_bwd_dq_tc": fa.dq_tc_launches,
            "flash_bwd_dkv_tc": fa.dkv_tc_launches,
            "flash_bwd_dq_f32": fa.dq_launches - fa.dq_tc_launches,
            "flash_bwd_dkv_f32": fa.dkv_launches - fa.dkv_tc_launches}


def require_routes(fa, label: str, tc: int, f32: int,
                   fwd: tuple | None = None) -> dict:
    """Fail unless K3 and K4 each launched ``tc`` times on the
    tensor-core route and ``f32`` times on the f32 route since the
    counters were zeroed, and K1 ``fwd`` = (tensor-core, f32) times (by
    default as K3); returns the routes' counts."""
    fwd_tc, fwd_f32 = fwd if fwd is not None else (tc, f32)
    routes = flash_routes(fa)
    want = {"flash_fwd_tc": fwd_tc, "flash_fwd_f32": fwd_f32,
            "flash_bwd_dq_tc": tc, "flash_bwd_dkv_tc": tc,
            "flash_bwd_dq_f32": f32, "flash_bwd_dkv_f32": f32}
    print(f"{label}: K1/K3/K4 launches by route {routes} (expected "
          f"{want})", flush=True)
    if routes != want:
        fail(f"{label}: K1/K3/K4 took the routes {routes}, expected {want}")
    return routes


def require_fwd_route(fa, label: str, tc: bool) -> None:
    """Fail unless every K1 launch since the counters were zeroed took
    the tensor-core route (``tc``, bf16) or every one the CUDA-core
    route (f32)."""
    if fa.tc_launches != (fa.launches if tc else 0):
        fail(f"{label}: {fa.tc_launches} of {fa.launches} K1 launches on "
             f"the tensor-core route, expected "
             f"{'all' if tc else 'none'}")


def require_gmm_routes(gm, label: str, tc: int, f32: int, dw_tc: int,
                       dw_f32: int) -> dict:
    """Fail unless K5 launched ``tc`` times on the tensor-core route and
    ``f32`` times on the CUDA-core route since the counters were
    zeroed, and K6 ``dw_tc`` and ``dw_f32`` times; returns the routes'
    counts."""
    routes = {"gmm_tc": gm.tc_launches,
              "gmm_f32": gm.launches["gmm"] - gm.tc_launches,
              "gmm_dw_tc": gm.dw_tc_launches,
              "gmm_dw_f32": gm.launches["gmm_dw"] - gm.dw_tc_launches}
    want = {"gmm_tc": tc, "gmm_f32": f32, "gmm_dw_tc": dw_tc,
            "gmm_dw_f32": dw_f32}
    print(f"{label}: K5/K6 launches by route {routes} (expected {want})",
          flush=True)
    if routes != want:
        fail(f"{label}: K5/K6 took the routes {routes}, expected {want}")
    return routes


def train_counts(fa) -> dict:
    return {"flash_fwd": fa.launches, "flash_bwd_dq": fa.dq_launches,
            "flash_bwd_dkv": fa.dkv_launches}


def step_param_errors(p_c, p_h, g_h) -> tuple[float, float, int]:
    """Card-vs-CPU parameters after one AdamW step: (largest difference
    outside the noise band, largest inside it, entries inside it).  The
    band holds the entries whose CPU gradient is nonzero and below
    NOISE_BAND of its tensor's largest entry: there the gradient is f32
    rounding noise around zero, which AdamW's first update
    lr * g / (|g| + eps) turns into an arbitrary fraction of a step, so
    callers hold those entries to two steps."""
    strict = noisy = 0.0
    n_noisy = 0
    for a, b, g in zip(p_c, p_h, g_h):
        band = (g != 0) & (g.abs() < NOISE_BAND * g.abs().max())
        n_noisy += int(band.sum())
        diff = (a - b).abs()
        strict = max(strict, float(diff[~band].max()) if (~band).any()
                     else 0.0)
        noisy = max(noisy, float(diff[band].max()) if band.any() else 0.0)
    return strict, noisy, n_noisy


def small_train_config():
    """The f32 2-layer config of the card-vs-CPU steps."""
    from k8s_dra_driver_tpu_torch.models.transformer import (
        TransformerConfig)
    return TransformerConfig(vocab=512, d_model=256, n_layers=2, n_heads=4,
                             n_kv_heads=2, d_head=64, d_ff=512, max_seq=256,
                             dtype=torch.float32)


def small_batch(cfg):
    """The small steps' global batch: tokens and packed segments [2,
    256] from numpy seed 5."""
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab, (2, 256)).astype(np.int32)
    seg = np.cumsum(rng.integers(0, 64, (2, 256)) == 0, axis=1).astype(
        np.int32)
    return tokens, seg


def small_step(cfg, device, tokens, seg, mesh=None):
    """One AdamW step of ``cfg`` from generator seed 3 on ``device``
    (over ``mesh`` when given): (loss, parameters after the step,
    gradients), the tensors on the host."""
    from k8s_dra_driver_tpu_torch.models.transformer import (
        make_train_step, named_tensors)
    step, init_state = make_train_step(cfg, device=device, mesh=mesh)
    params, opt = init_state(torch.Generator().manual_seed(3))
    params, opt, loss = step(params, opt, tokens, seg)
    leaves = named_tensors(params)
    missing = [n for n, t in leaves if t.grad is None]
    if missing:
        fail(f"train step on {device}: no gradient for {missing}")
    return (float(loss), [t.detach().cpu() for _, t in leaves],
            [t.grad.detach().cpu() for _, t in leaves])


def phase_train_small(fa) -> dict:
    """One f32 AdamW step of a small config on the card (K1/K3/K4) and
    on the CPU (plain versions), from the same parameters and tokens,
    with packed segments; parameters compared by
    :func:`step_param_errors`.  Returns the card step's K3/K4 launches
    by route (all on the f32 route)."""
    cfg = small_train_config()
    tokens, seg = small_batch(cfg)
    results = {}
    for device in ("cuda", "cpu"):
        zero_counts(fa)
        loss, params, grads = small_step(cfg, device, tokens, seg)
        if device == "cuda":
            routes = require_routes(fa, "train f32 small step", 0,
                                    cfg.n_layers)
        results[device] = (loss, params, grads, train_counts(fa))
    (l_c, p_c, _, counts), (l_h, p_h, g_h, _) = (results["cuda"],
                                                 results["cpu"])
    if min(counts.values()) != cfg.n_layers:
        fail(f"small f32 step launched {counts}: each kernel once per "
             f"layer expected")
    loss_rel = abs(l_c - l_h) / abs(l_h)
    strict, noisy, n_noisy = step_param_errors(p_c, p_h, g_h)
    ok = (loss_rel <= STEP_LOSS_RTOL and strict <= STEP_PARAM_ATOL
          and noisy <= 2 * 3e-4)
    print(f"train f32 small step, card (kernels) vs CPU (plain): loss "
          f"{l_c:.7f} vs {l_h:.7f} (rel {loss_rel:.3g}, tol "
          f"{STEP_LOSS_RTOL}); params max|d| {strict:.3g} (tol "
          f"{STEP_PARAM_ATOL}), {n_noisy} noise-band entries max|d| "
          f"{noisy:.3g} (tol 6e-4); launches {counts} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("the card's f32 train step disagrees with the CPU's")
    return routes


def state_snapshot(params, opt) -> list:
    """Every tensor of (params, optimizer state) copied, in a fixed
    order, for a bitwise comparison."""
    from k8s_dra_driver_tpu_torch.models.transformer import named_tensors
    out = [t.detach().clone() for _, t in named_tensors(params)]
    state = opt.state_dict()["state"]
    for i in sorted(state):
        for key in sorted(state[i]):
            out.append(torch.as_tensor(state[i][key]).detach().clone())
    return out


def phase_train(fa, tmp: Path, record: dict) -> dict:
    """The 154M configuration trained at full width: TRAIN_STEPS AdamW
    steps of B=8 x T=2048 with the K1/K3/K4 counters zeroed just before
    and read just after, a checkpoint at TRAIN_SAVE_AT, the resume
    check, and one step under remat.  Returns the steps' launches;
    ``record`` gets the losses and the first SP_STEPS batches, which
    the sp phase trains again."""
    from k8s_dra_driver_tpu_torch.models.checkpoint import (
        TrainCheckpointer)
    from k8s_dra_driver_tpu_torch.models.data import (BatchLoader,
                                                      load_token_file,
                                                      write_token_file)
    from k8s_dra_driver_tpu_torch.models.transformer import make_train_step
    cfg = serving_config()
    # a repeated 32-token motif (as the JAX package's training probe
    # builds its corpus), two epochs of 16 windows
    motif = np.random.default_rng(0).integers(0, cfg.vocab, 32)
    corpus = np.tile(motif, 2 * TRAIN_B * TRAIN_T // 32)
    path = write_token_file(corpus, tmp / "corpus.bin", cfg.vocab)

    def loader():
        return BatchLoader(load_token_file(path, cfg.vocab), batch=TRAIN_B,
                           seq_len=TRAIN_T, seed=0)

    step, init_state = make_train_step(cfg, device="cuda")
    params, opt = init_state(torch.Generator(device="cuda").manual_seed(0))
    data = loader()
    ckpt = TrainCheckpointer(tmp / "ckpt", keep=2)
    losses, walls, saved = [], [], None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(fa)
    record["batches"] = []
    for i in range(1, TRAIN_STEPS + 1):
        batch = next(data)
        if i <= SP_STEPS:
            record["batches"].append(batch)
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))          # waits for the step
        walls.append(time.perf_counter() - t0)
        if i == TRAIN_SAVE_AT:
            ckpt.save(i, params, opt, extra=data.state_dict())
            saved = state_snapshot(params, opt)
    counts = train_counts(fa)
    record["losses"] = losses
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    steady = walls[1:]
    step_ms = 1e3 * sum(steady) / len(steady)
    print(f"train 154M B={TRAIN_B} T={TRAIN_T} bf16: losses "
          f"{[round(x, 5) for x in losses]}; step wall ms "
          f"{[round(1e3 * w, 1) for w in walls]} (mean of steps 2-"
          f"{TRAIN_STEPS}: {step_ms:.1f} ms = "
          f"{TRAIN_B * TRAIN_T / (step_ms / 1e3):.0f} tokens/s); peak "
          f"device memory {peak_gb:.2f} GiB; kernel launches {counts}",
          flush=True)
    if not all(np.isfinite(losses)):
        fail(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"training loss did not fall: {losses}")
    if min(counts.values()) <= 0:
        fail(f"training launched {counts}: every kernel must be > 0")
    counts.update(require_routes(fa, "train 154M",
                                 cfg.n_layers * TRAIN_STEPS, 0))

    # resume: a fresh state from another seed, restored from step 3
    params2, opt2 = init_state(torch.Generator(device="cuda").manual_seed(9))
    params2, opt2, at = ckpt.restore(params2, opt2)
    restored = state_snapshot(params2, opt2)
    same = (at == TRAIN_SAVE_AT and len(restored) == len(saved)
            and all(a.dtype == b.dtype and a.device == b.device
                    and torch.equal(a, b)
                    for a, b in zip(restored, saved)))
    data2 = loader()
    data2.load_state_dict(ckpt.restore_extra(at))
    resumed = []
    for _ in range(TRAIN_SAVE_AT, TRAIN_STEPS):
        params2, opt2, loss = step(params2, opt2, next(data2))
        resumed.append(float(loss))
    ckpt.close()
    gap = max(abs(a - b) for a, b in zip(resumed, losses[TRAIN_SAVE_AT:]))
    ok = same and gap <= RESUME_TOL
    print(f"train resume from step {at}: {len(saved)} tensors bitwise "
          f"equal={same}; losses {[round(x, 5) for x in resumed]} vs "
          f"{[round(x, 5) for x in losses[TRAIN_SAVE_AT:]]} (max|d| "
          f"{gap:.3g}, tol {RESUME_TOL}) {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        fail("the restored training state or its losses disagree")
    del saved, restored

    # remat: the layer forward runs again in the backward, so K1 twice
    step_r, _ = make_train_step(dataclasses.replace(cfg, remat=True),
                                device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(fa)
    t0 = time.perf_counter()
    params2, opt2, loss = step_r(params2, opt2, next(data2))
    remat_loss = float(loss)
    remat_ms = 1e3 * (time.perf_counter() - t0)
    remat_counts = train_counts(fa)
    remat_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {"flash_fwd": 2 * cfg.n_layers, "flash_bwd_dq": cfg.n_layers,
            "flash_bwd_dkv": cfg.n_layers}
    print(f"train remat step: loss {remat_loss:.5f}, wall {remat_ms:.1f} "
          f"ms, peak device memory {remat_gb:.2f} GiB, launches "
          f"{remat_counts} (expected {want})", flush=True)
    if remat_counts != want or not np.isfinite(remat_loss):
        fail("the remat step's launches or loss are wrong")
    require_routes(fa, "train remat step", cfg.n_layers, 0,
                   fwd=(2 * cfg.n_layers, 0))
    return counts


#: the gang recovery phase: the kill arc's steps, the checkpoint cadence,
#: the f32 arc's batch, and the tolerance of its losses against an
#: uninterrupted dp=4 run (summation order only: a dp change is a
#: placement change)
GANG_STEPS = 8
GANG_EVERY = 2
GANG_F32_B, GANG_F32_T = 4, 512
#: the f32 arc's depth: the 154M's widths at two of its eight layers (its
#: five generations of 1.8 GiB at eight took about 30 s of the script's
#: time limit; a dp change is a placement change at any depth)
GANG_F32_LAYERS = 2
GANG_F32_RTOL = 1e-4
#: live bytes a parked gang may leave behind, over the pre-begin reading
GANG_PARK_SLACK = 16 * 2 ** 20
#: the wedge arc's step deadline: this many steady dp=4 step walls, and
#: never under GANG_MIN_DEADLINE_S
GANG_DEADLINE_X = 5.0
GANG_MIN_DEADLINE_S = 1.0


class TimedSaves:
    """Wraps a checkpointer's ``save`` and ``restore``: each save that
    wrote a generation records (step, bytes, ms), each skipped one
    (step already committed) is counted, each restore records (step,
    ms)."""

    def __init__(self, ckpt):
        self.ckpt = ckpt
        self.saves, self.skipped, self.restores = [], 0, []
        save, restore = ckpt.save, ckpt.restore

        def timed_save(step, params, opt, wait=True, extra=None, mesh=None):
            before = set(ckpt.all_steps())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            save(step, params, opt, wait=wait, extra=extra, mesh=mesh)
            ms = 1e3 * (time.perf_counter() - t0)
            if step in before:
                self.skipped += 1
            else:
                self.saves.append((step, generation_bytes(ckpt, step), ms))

        def timed_restore(params, opt, step=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = restore(params, opt, step=step)
            torch.cuda.synchronize()
            self.restores.append((out[2], 1e3 * (time.perf_counter() - t0)))
            return out

        ckpt.save, ckpt.restore = timed_save, timed_restore

    def line(self) -> str:
        gens = ", ".join(
            f"step {s}: {b / 2 ** 20:.1f} MiB in {ms:.0f} ms "
            f"({b / 2 ** 20 / (ms / 1e3):.0f} MiB/s)"
            for s, b, ms in self.saves)
        rest = ", ".join(f"step {s} in {ms:.0f} ms" for s, ms in
                         self.restores)
        return (f"generations written [{gens}]; {self.skipped} saves of a "
                f"committed step skipped; restores [{rest}]")


def generation_bytes(ckpt, step: int) -> int:
    """Bytes of one committed generation on disk."""
    from k8s_dra_driver_tpu_torch.parallel.resharding import (
        ShardedCheckpointer)
    if isinstance(ckpt, ShardedCheckpointer):
        root = ckpt.step_path(step)
    else:
        root = ckpt.directory / str(step)
    return sum(p.stat().st_size for p in root.rglob("*") if p.is_file())


def timed_job(cfg, corpus, batch: int, seq_len: int, walls: list):
    """``ElasticTrainJob`` on this card over 4 chip slots whose train
    step appends ``(dp, wall seconds)`` to ``walls`` (the card
    synchronized before the clock reads)."""
    from k8s_dra_driver_tpu_torch.parallel.supervisor import (
        ElasticTrainJob)

    class Job(ElasticTrainJob):
        def build(self, dp, exclude_chips=frozenset(), tp=None):
            gang, step, init_state = super().build(dp, exclude_chips, tp)

            def timed(params, opt, tokens):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(params, opt, tokens)
                torch.cuda.synchronize()
                walls.append((dp, time.perf_counter() - t0))
                return out

            return gang, timed, init_state

    return Job(cfg, corpus, batch=batch, seq_len=seq_len, chips=4, tp=1,
               device="cuda")


def steady_ms(walls, dp: int) -> float:
    """Mean wall of the steps at ``dp`` past the first of each
    formation at that width."""
    runs, prev = [], None
    for d, w in walls:
        if d == dp and prev == dp:
            runs.append(w)
        prev = d
    if not runs:
        fail(f"gang: no steady step at dp={dp}")
    return 1e3 * sum(runs) / len(runs)


def gang_supervisor(job, ckpt, coord: Path, *, plan=None,
                    checkpoint_every: int = GANG_EVERY,
                    step_deadline_s: float = 60.0):
    from k8s_dra_driver_tpu_torch.parallel.supervisor import GangSupervisor
    return GangSupervisor(job, ckpt, coordination_dir=coord, dp=4,
                          fault_plan=plan, checkpoint_every=checkpoint_every,
                          step_deadline_s=step_deadline_s,
                          first_step_deadline_s=600.0)


def gang_plan(name: str, skip: int, error: str = "crash",
              latency_s: float = 0.0):
    """One fault on gang worker ``name`` after ``skip`` decisions."""
    from k8s_dra_driver_tpu_torch.cluster.faults import FaultPlan, FaultRule
    return FaultPlan([FaultRule(verb="gang", kind="Worker", name=name,
                                skip=skip, times=1, error=error,
                                latency_s=latency_s)])


def gang_corpus(cfg, batch: int, seq_len: int) -> np.ndarray:
    """phase_train's corpus: a repeated 32-token motif, two epochs."""
    motif = np.random.default_rng(0).integers(0, cfg.vocab, 32)
    return np.tile(motif, 2 * batch * seq_len // 32)


def check_kill_arc(sup, report, label: str) -> None:
    """The gates of tests/test_supervisor.py's kill arc."""
    from k8s_dra_driver_tpu_torch.parallel import supervisor as sv
    recs = report.recoveries
    rec = recs[0] if recs else None
    losses = [l for _, l in report.losses]
    reg = sup.metrics.registry
    contract = json.loads((sup.dir / sv.CONTRACT_FILENAME).read_text())
    problems = []
    if len(recs) != 1 or rec.cause != "dead" or rec.victims != ["g0w2"]:
        problems.append(f"recoveries {recs}")
    elif ((rec.from_dp, rec.to_dp) != (4, 2) or rec.restored_step != 4
          or rec.steps_lost > GANG_EVERY or not rec.mttr_s > 0):
        problems.append(f"recovery {rec}")
    if report.transitions != [sv.RUNNING, sv.SUSPECT, sv.EVICT, sv.REFORM,
                              sv.RESUME, sv.RUNNING]:
        problems.append(f"transitions {report.transitions}")
    if [s for s, _ in report.losses] != list(range(1, GANG_STEPS + 1)):
        problems.append(f"steps {[s for s, _ in report.losses]}")
    if not all(np.isfinite(losses)) or not losses[-1] < min(losses[:4]):
        problems.append(f"losses {losses}")
    if (contract["num_workers"], contract["generation"],
            contract["excluded_chips"]) != (2, 1, [2]):
        problems.append(f"contract {contract}")
    want = {("tpu_train_restarts_total", (("cause", "dead"),)): 1,
            ("tpu_train_recovery_seconds_count", ()): 1,
            ("tpu_train_dp_width", ()): 2,
            ("tpu_train_supervisor_state", (("state", sv.RUNNING),)): 1}
    for (name, labels), value in want.items():
        if reg.get_sample_value(name, dict(labels)) != value:
            problems.append(f"{name}{dict(labels)} = "
                            f"{reg.get_sample_value(name, dict(labels))}")
    if reg.get_sample_value("tpu_train_steps_lost_total") > GANG_EVERY:
        problems.append("tpu_train_steps_lost_total")
    if problems:
        fail(f"gang {label}: " + "; ".join(map(str, problems)))


def phase_gang_recovery(fa, pa, tmp: Path) -> tuple[dict, dict]:
    """Training recovery: ``GangSupervisor`` over
    ``ElasticTrainJob(chips=4, device="cuda")`` with the 154M at full
    width (B=8 x T=2048, bf16), every dp row of a step its own forward
    and backward.

    (a) The kill arc (tests/test_supervisor.py's): dp=4,
    ``ShardedCheckpointer`` (keep 2, the transformer's rules), a
    generation every GANG_EVERY steps, GANG_STEPS steps, ``g0w2``
    crashing after 4 decisions.  Gated: one recovery, cause ``dead``,
    victims ``["g0w2"]``, dp 4 → 2, restored step 4, steps lost <=
    GANG_EVERY, MTTR > 0; the transitions RUNNING, SUSPECT, EVICT,
    REFORM, RESUME, RUNNING; steps 1..8 each once, the last loss below
    the pre-kill minimum; the contract file at 2 workers, generation 1,
    chip 2 excluded; ``RecoveryMetrics`` as that test reads it; K1, K3
    and K4 each exactly n_layers x the rows of every step (4 before the
    kill, 2 after), all on the tensor cores.  Printed: MTTR, each
    generation's bytes with its save ms and MiB/s, the restore ms, the
    steady step wall at dp=4 and dp=2.  (b) The wedge: a ``hang`` on
    ``g0w1`` after the two warm-up steps, the step deadline
    GANG_DEADLINE_X steady dp=4 walls: cause ``wedged``, victims
    ``["g0w1"]``, dp 4 → 2, every step once.  (c) Placement, not math:
    the kill arc in f32 at B=4 x T=512 on the 154M's widths at
    GANG_F32_LAYERS layers, each step's loss within
    GANG_F32_RTOL of an uninterrupted dp=4 run's; then one byte flipped
    in the newest generation's largest shard: ``restore()`` falls back
    to the previous generation and ``read_slice`` of that shard raises
    ``ShardCorruption``.  (d) ``request_width(2)``, ``park()`` and
    ``request_width(4)``, each at a checkpoint step, over
    ``TrainCheckpointer``: zero steps lost, the card's live bytes after
    the park within GANG_PARK_SLACK of the pre-begin reading, the
    unpark restored from the park's step.  (e) ``recovery_probe``,
    ``fleet_probe`` and ``multitenant_probe`` on the card at their own
    defaults, the reference's widths (d_model 32, 4 heads of 8, f32):
    ``valid`` gated; MTTR, steps lost, the preempt and cascade ms and
    their K1/K2 launches printed.  Returns (the bf16 arcs' K1/K3/K4
    launches, totals and by route; the f32 ones' by route)."""
    from k8s_dra_driver_tpu_torch.fleet import fleet_probe, multitenant_probe
    from k8s_dra_driver_tpu_torch.models.checkpoint import TrainCheckpointer
    from k8s_dra_driver_tpu_torch.models.layouts import transformer_rules
    from k8s_dra_driver_tpu_torch.models.transformer import TransformerConfig
    from k8s_dra_driver_tpu_torch.parallel import supervisor as sv
    from k8s_dra_driver_tpu_torch.parallel.probe import recovery_probe
    from k8s_dra_driver_tpu_torch.parallel.resharding import (
        ShardCorruption, ShardedCheckpointer)

    cfg = serving_config()
    corpus = gang_corpus(cfg, TRAIN_B, TRAIN_T)
    layers = cfg.n_layers
    t_phase = time.perf_counter()

    # (a) the kill arc, bf16
    walls: list = []
    ckpt = ShardedCheckpointer(tmp / "a", keep=2,
                               rules=transformer_rules(cfg))
    saves = TimedSaves(ckpt)
    sup = gang_supervisor(timed_job(cfg, corpus, TRAIN_B, TRAIN_T, walls),
                          ckpt, tmp / "a-coord",
                          plan=gang_plan("g0w2", 4))
    zero_counts(fa)
    report = sup.run(GANG_STEPS)
    torch.cuda.synchronize()
    check_kill_arc(sup, report, "(a)")
    rows = 4 * 4 + 2 * (GANG_STEPS - 4)
    routes = train_counts(fa)
    routes.update(require_routes(fa, "gang (a) kill arc", layers * rows, 0))
    rec = report.recoveries[0]
    ms4, ms2 = steady_ms(walls, 4), steady_ms(walls, 2)
    print(f"gang (a) 154M bf16 kill arc: dp 4 -> 2 at step "
          f"{rec.restored_step}, steps lost {rec.steps_lost}, MTTR "
          f"{1e3 * rec.mttr_s:.1f} ms; transitions {report.transitions}; "
          f"losses {[round(l, 4) for _, l in report.losses]}; steady "
          f"step wall {ms4:.1f} ms at dp=4, {ms2:.1f} ms at dp=2; "
          f"K1/K3/K4 {layers} x {rows} rows each (gated)", flush=True)
    print(f"gang (a) checkpoints: {saves.line()}", flush=True)
    if not saves.saves or not saves.restores:
        fail("gang (a): no generation written or restored")
    del sup, report, ckpt, saves
    gc.collect()

    # (b) the wedge, bf16
    walls = []
    deadline = max(GANG_MIN_DEADLINE_S, GANG_DEADLINE_X * ms4 / 1e3)
    # the first step past the two warm-up steps hangs (steady deadline)
    plan = gang_plan("g0w1", 2, "hang", 600.0)
    ckpt = TrainCheckpointer(tmp / "b", keep=2)
    sup = gang_supervisor(timed_job(cfg, corpus, TRAIN_B, TRAIN_T, walls),
                          ckpt, tmp / "b-coord", plan=plan,
                          step_deadline_s=deadline)
    zero_counts(fa)
    t0 = time.perf_counter()
    report = sup.run(6)
    wall_b = time.perf_counter() - t0
    ckpt.close()
    recs = report.recoveries
    if (len(recs) != 1 or recs[0].cause != "wedged"
            or recs[0].victims != ["g0w1"]
            or (recs[0].from_dp, recs[0].to_dp) != (4, 2)
            or [s for s, _ in report.losses] != list(range(1, 7))):
        fail(f"gang (b): recoveries {recs}, steps "
             f"{[s for s, _ in report.losses]}")
    for name, n in {**train_counts(fa), **flash_routes(fa)}.items():
        routes[name] += n
    print(f"gang (b) 154M bf16 wedge: step deadline {deadline:.2f} s; "
          f"cause {recs[0].cause}, victims {recs[0].victims}, dp 4 -> 2, "
          f"restored step {recs[0].restored_step}, MTTR "
          f"{1e3 * recs[0].mttr_s:.1f} ms; run {wall_b:.1f} s (gated)",
          flush=True)
    del sup, report, ckpt
    gc.collect()

    # (c) placement, not math, f32
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32,
                                n_layers=GANG_F32_LAYERS)
    corpus32 = gang_corpus(cfg32, GANG_F32_B, GANG_F32_T)
    zero_counts(fa)
    ref = gang_supervisor(
        timed_job(cfg32, corpus32, GANG_F32_B, GANG_F32_T, []),
        TrainCheckpointer(tmp / "c-ref", keep=1), tmp / "c-ref-coord",
        checkpoint_every=10 ** 6)
    ref_losses = [l for _, l in ref.run(GANG_STEPS).losses]
    ref.ckpt.close()
    del ref
    ckpt = ShardedCheckpointer(tmp / "c", keep=2,
                               rules=transformer_rules(cfg32))
    sup = gang_supervisor(
        timed_job(cfg32, corpus32, GANG_F32_B, GANG_F32_T, []), ckpt,
        tmp / "c-coord", plan=gang_plan("g0w2", 4))
    report = sup.run(GANG_STEPS)
    check_kill_arc(sup, report, "(c)")
    losses = [l for _, l in report.losses]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    f32_routes = flash_routes(fa)
    print(f"gang (c) 154M widths at {GANG_F32_LAYERS} layers, f32 "
          f"B={GANG_F32_B} T={GANG_F32_T} kill arc "
          f"against an uninterrupted dp=4 run: max relative loss gap "
          f"{rel:.3g} (tol {GANG_F32_RTOL}); losses "
          f"{[round(l, 5) for l in losses]}", flush=True)
    if not rel <= GANG_F32_RTOL:
        fail(f"gang (c): losses {losses} against {ref_losses}")
    newest = ckpt.latest_step()
    leaves = ckpt._read_manifest(ckpt.step_path(newest))["leaves"]
    name, shard = max(((n, sh) for n, e in leaves.items()
                       for sh in e["shards"]),
                      key=lambda kv: kv[1]["nbytes"])
    path = ckpt.step_path(newest) / shard["file"]
    with open(path, "r+b") as f:
        f.seek(shard["nbytes"] // 2)
        byte = f.read(1)
        f.seek(shard["nbytes"] // 2)
        f.write(bytes([byte[0] ^ 0xFF]))
    params, opt = sup.init_state(sup._key())
    _, _, at = ckpt.restore(params, opt)
    try:
        ckpt.read_slice(newest, name, bounds=shard["bounds"])
        detected = False
    except ShardCorruption:
        detected = True
    print(f"gang (c) one byte flipped in {shard['file']} "
          f"({shard['nbytes']} bytes) of step {newest}: restore fell back "
          f"to step {at}, read_slice raised ShardCorruption={detected}",
          flush=True)
    if at != ckpt.all_steps()[-2] or not detected:
        fail(f"gang (c): restore at {at} of {ckpt.all_steps()}, "
             f"detected={detected}")
    del sup, report, ckpt, params, opt
    gc.collect()

    # (d) resize, park and unpark at a checkpoint step
    walls = []
    torch.cuda.empty_cache()
    base = allocated()
    ckpt = TrainCheckpointer(tmp / "d", keep=2)
    sup = gang_supervisor(timed_job(cfg, corpus, TRAIN_B, TRAIN_T, walls),
                          ckpt, tmp / "d-coord")
    zero_counts(fa)
    sup.begin(GANG_STEPS)
    while sup._step < GANG_EVERY:
        sup.step_once()
    sup.request_width(2)
    sup.step_once()
    sup.park()
    sup.step_once()
    gc.collect()
    parked = allocated()
    sup.request_width(4)
    sup.step_once()
    while sup.step_once():
        pass
    report = sup.report()
    ckpt.close()
    causes = [(r.cause, r.restored_step, r.steps_lost)
              for r in report.recoveries]
    residue = parked - base
    print(f"gang (d) 154M bf16 request_width(2), park(), request_width(4) "
          f"at step {GANG_EVERY}: recoveries {causes}; live bytes before "
          f"begin {base}, parked {parked} (residue {residue}, slack "
          f"{GANG_PARK_SLACK}); steps {[s for s, _ in report.losses]}",
          flush=True)
    if (causes != [("preempt", GANG_EVERY, 0), ("park", GANG_EVERY, 0),
                   ("expand", GANG_EVERY, 0)]
            or abs(residue) > GANG_PARK_SLACK
            or sv.PARKED not in report.transitions
            or [s for s, _ in report.losses]
            != list(range(1, GANG_STEPS + 1))):
        fail("gang (d): the resize and park arc lost steps or held memory")
    for name, n in {**train_counts(fa), **flash_routes(fa)}.items():
        routes[name] += n
    del sup, report, ckpt
    gc.collect()

    # (e) the probes on the card, at their reference defaults
    for label, fn, keys in (
            ("recovery_probe", recovery_probe,
             ("mttr_ms", "steps_lost_worst")),
            ("fleet_probe", fleet_probe,
             ("scaleup_ms", "preempt_ms", "regrow_ms")),
            ("multitenant_probe", multitenant_probe,
             ("preempt_cascade_ms", "regrow_ms", "frag_win_x",
              "fairshare_err"))):
        zero_counts(fa)
        pa.launches = 0
        out = fn(device="cuda")
        counts = kernel_snapshot(fa, pa)
        print(f"gang (e) {label} on the card (reference widths, d_head 8, "
              f"tp={out['tp']}): "
              + ", ".join(f"{k} {out[k]}" for k in keys)
              + f", causes {out.get('recovery_causes', '-')}, K1 "
              f"{counts['flash_fwd']}, K2 {counts['paged_decode']}, valid "
              f"{out['valid']} (gated)", flush=True)
        if not out["valid"] or counts["flash_fwd"] <= 0:
            fail(f"gang (e): {label} {out}")
        for name, n in flash_routes(fa).items():
            f32_routes[name] += n
    print(f"gang phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return routes, f32_routes


#: the crucible's full-width run: the smallest default-schedule length
#: of at least 60 at which the soak passes in either package
#: (tests/test_torch_crucible_soak.py pins it on the CPU)
CRUCIBLE_FULL_CYCLES = 88
#: (a)'s soak on the reference's model: the same length (the
#: reference acceptance runs 220 cycles; 88 keeps the script inside its
#: time limit on a slow host, and 88-160 and 220 pass alike)
CRUCIBLE_SOAK_CYCLES = CRUCIBLE_FULL_CYCLES
#: (b)'s gangs: the 154M's widths at this depth.  At all 8 layers the
#: gangs' 79 saves of a 879 MiB generation took about 200 of (b)'s
#: 239-257 s on the H100 and the whole script 958 s of its 1200 s limit
#: (PERF.md section 6); two layers keep every width and cut the bytes
#: to 57%
CRUCIBLE_GANG_LAYERS = 2
#: the four window-triggered double-fault arcs of the default schedule
CRUCIBLE_ARCS = ("mid-chip4-in-reform", "decode-kill-in-handoff",
                 "chip0-in-cascade", "chip1-while-parked")


class ShardedSaveTimer:
    """Times every ``ShardedCheckpointer`` save and restore of a block
    (the class's methods are wrapped, so checkpointers a rig builds are
    covered): each save that wrote a generation records (bytes, ms),
    each successful restore (step, ms)."""

    def __enter__(self):
        from k8s_dra_driver_tpu_torch.parallel.resharding import (
            ShardedCheckpointer)
        self.cls = ShardedCheckpointer
        self.save0, self.restore0 = self.cls.save, self.cls.restore
        self.saves, self.restores = [], []
        timer = self

        def save(ck, step, params, opt_state, wait=True, extra=None,
                 mesh=None):
            before = set(ck.all_steps())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            timer.save0(ck, step, params, opt_state, wait=wait, extra=extra,
                        mesh=mesh)
            ms = 1e3 * (time.perf_counter() - t0)
            if step not in before and step in ck.all_steps():
                timer.saves.append((generation_bytes(ck, step), ms))

        def restore(ck, params_like, opt_state_like, step=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = timer.restore0(ck, params_like, opt_state_like, step=step)
            torch.cuda.synchronize()
            timer.restores.append((out[2], 1e3 * (time.perf_counter() - t0)))
            return out

        self.cls.save, self.cls.restore = save, restore
        return self

    def __exit__(self, *exc):
        self.cls.save, self.cls.restore = self.save0, self.restore0
        return False


def crucible_model(cfg, label: str):
    """(cfg, params): ``cfg`` with weights from generator seed 0 on the
    card."""
    from k8s_dra_driver_tpu_torch.models.transformer import init_params
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    n = sum(p.numel() for p in param_tensors(params))
    print(f"crucible {label}: model {n} parameters, {cfg.dtype}, "
          f"d_head {cfg.d_head}", flush=True)
    return cfg, params


def crucible_gates(label: str, sched, res, rig, cycles: int) -> None:
    """Every assertion of the reference acceptance
    (tests/test_crucible.py test_compound_soak_zero_violations)."""
    bad = [f"cycle {c}: {m}" for c, v in res.violations for m in v]
    from k8s_dra_driver_tpu_torch.cluster import crucible as cru
    from k8s_dra_driver_tpu_torch.cluster import invariants as inv
    if bad:
        fail(f"{label}: {len(bad)} violation(s): {bad[:8]}")
    if not (res.cycles >= cycles and res.survived_cycles == res.cycles):
        fail(f"{label}: survived {res.survived_cycles} of {res.cycles} "
             f"cycles, want {cycles}")
    if set(res.fault_kinds_fired) != set(cru.EVENT_KINDS):
        fail(f"{label}: kinds fired {res.fault_kinds_fired}, want every "
             f"one of {cru.EVENT_KINDS}")
    if res.overlap_hits < 3:
        fail(f"{label}: {res.overlap_hits} overlap hits, want >= 3")
    if res.gang_failures or res.operator_repairs:
        fail(f"{label}: gang failures {res.gang_failures}, operator "
             f"repairs {res.operator_repairs}")
    if not (res.submitted > 0 and res.finished == res.submitted):
        fail(f"{label}: {res.finished} of {res.submitted} finished")
    if not res.compound_mttr_ms > 0:
        fail(f"{label}: no recovery MTTR measured")
    for name, sup in rig.sups.items():
        lost = inv.losses_exactly_once(sup.losses, sup.recoveries)
        if not sup.recoveries or lost:
            fail(f"{label}: gang {name} recoveries {sup.recoveries}, "
                 f"losses {lost}")
    by_id = {e.id: e for e in sched.events}
    for eid in CRUCIBLE_ARCS:
        if by_id[eid].fired_cycle is None or not by_id[eid].hit_windows:
            fail(f"{label}: {eid} fired at {by_id[eid].fired_cycle} in "
                 f"windows {by_id[eid].hit_windows}")
    if rig.burn.cycle < res.cycles or rig.burn.alerts_total:
        fail(f"{label}: burn engine at cycle {rig.burn.cycle}, "
             f"{rig.burn.alerts_total} alerts")
    victims = [info for _, kind, info in rig.rec.events
               if kind.startswith("reclaim") and info.get("tenant") == "hi"]
    if victims:
        fail(f"{label}: the serving tenant was a reclaim victim {victims}")


def crucible_soak(fa, pa, label, cycles, workdir, **kw):
    """One default-schedule soak through ``run_soak`` with the counts
    zeroed just before and read just after; prints the run's line.
    Returns (schedule, result, rig, counts, wall s)."""
    from k8s_dra_driver_tpu_torch.cluster import crucible as cru
    sched = cru.default_schedule(7, cycles=cycles)
    zero_counts(fa)
    pa.launches = 0
    t0 = time.perf_counter()
    res, rig = cru.run_soak(sched, workdir, device="cuda", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {**flash_routes(fa), "paged_decode": pa.launches,
              "flash_fwd": fa.launches}
    recs = {name: [(r.cause, r.from_dp, r.to_dp, r.restored_step,
                    r.steps_lost) for r in sup.recoveries]
            for name, sup in rig.sups.items()}
    fired = sorted(res.fault_kinds_fired)
    print(f"crucible {label}: default_schedule(7, cycles={cycles}) in "
          f"{wall:.1f} s ({res.cycles / wall:.2f} cycles/s over "
          f"{res.cycles} cycles with the drain), MTTR "
          f"{res.compound_mttr_ms:.1f} ms, violations "
          f"{sum(len(v) for _, v in res.violations)}, overlap hits "
          f"{res.overlap_hits}, {res.finished}/{res.submitted} finished, "
          f"kinds fired {len(fired)} {fired}, recoveries (cause, from_dp, "
          f"to_dp, restored step, steps lost) {recs}, burn cycle "
          f"{rig.burn.cycle} alerts {rig.burn.alerts_total}, "
          f"step_deadline_s {rig.step_deadline_s} hang_stall_s "
          f"{rig.hang_stall_s}, tier "
          f"corruptions {rig.tier_corruptions}, kv seizures "
          f"{rig.kv_seizures}, adapter storms {rig.adapter_storms}; "
          f"launches {counts}", flush=True)
    return sched, res, rig, counts, wall


def crucible_record(sched, rig) -> dict:
    """What a run must reproduce: each plan's injection log, every
    event's fired cycle and windows, every uid's outcome status and
    every finished token array."""
    plans = {"chip": rig.chip_plan.log, "replica": rig.replica_plan.log,
             **{f"gang-{n}": p.log for n, p in rig.gang_plans.items()}}
    return dict(
        plans={k: list(v) for k, v in plans.items()},
        fired=[(e.id, e.fired_cycle, tuple(e.hit_windows))
               for e in sched.events],
        outcomes={u: g.status for u, g in rig.gw.outcomes.items()},
        tokens={u: np.asarray(f.tokens).tolist()
                for u, f in rig.gw.results.items()})


def phase_crucible(fa, pa, tmp: Path) -> tuple[dict, dict]:
    """The compound-fault crucible on the card
    (``k8s_dra_driver_tpu_torch/cluster/crucible.py``): the full stack
    (a ShardedGateway over a one-prefill, one-decode paged, tiered,
    LoRA-carrying pool, two elastic gangs on ``ShardedCheckpointer``,
    ``MultiTenantReconciler`` over one 8-slot ledger, the burn engine
    and the tracer) in one co-loop under the seeded default schedule.

    (a) ``default_schedule(7, CRUCIBLE_SOAK_CYCLES)`` on the crucible's
    default model,
    the reference's (vocab 64, d_model 32, 2 layers, 4 heads of 8 over
    2 KV heads, d_ff 64, max_seq 48, f32):
    every assertion of the reference acceptance, K1 (f32 route), K2,
    K3 and K4 (f32 route) launched.  (b) The slice at full width:
    engines and oracles on the 154M in f32, the gangs on the 154M's
    widths at CRUCIBLE_GANG_LAYERS layers in bf16,
    ``default_schedule(7, CRUCIBLE_FULL_CYCLES)``: the same gates,
    K1 on both routes and K3/K4 on the tensor cores; the generations'
    count, bytes and save ms, the restores.  (c) The spec-fleet
    schedule (seed 11, 14 cycles, n-gram drafts) twice at (a)'s shape:
    equal injection logs, fired cycles and windows, outcomes and
    tokens; then a repro of it written and replayed, its fired cycles
    equal.  Returns the main-route and f32-route launch counts."""
    from k8s_dra_driver_tpu_torch.cluster import crucible as cru
    from k8s_dra_driver_tpu_torch.cluster.crucible import (FaultEvent,
                                                           Schedule)
    from k8s_dra_driver_tpu_torch.models.transformer import (
        TransformerConfig)
    t_phase = time.perf_counter()
    routes = {"flash_fwd": 0, "flash_fwd_tc": 0, "paged_decode": 0,
              "flash_bwd_dq_tc": 0, "flash_bwd_dkv_tc": 0}
    f32_routes = {"flash_bwd_dq_f32": 0, "flash_bwd_dkv_f32": 0}

    def add(counts):
        for name in routes:
            routes[name] += counts[name]
        for name in f32_routes:
            f32_routes[name] += counts[name]

    # (a) the reference acceptance on the reference's model
    small = cru.default_model("cuda")
    print(f"crucible (a): the default model, "
          f"{sum(p.numel() for p in param_tensors(small[1]))} parameters, "
          f"{small[0].dtype}, d_head {small[0].d_head}", flush=True)
    sched, res, rig, counts, _ = crucible_soak(
        fa, pa, "(a)", CRUCIBLE_SOAK_CYCLES, tmp / "a", model=small)
    crucible_gates("crucible (a)", sched, res, rig, CRUCIBLE_SOAK_CYCLES)
    if (counts["flash_fwd_f32"] <= 0 or counts["flash_fwd_tc"]
            or counts["paged_decode"] <= 0
            or counts["flash_bwd_dq_f32"] <= 0
            or counts["flash_bwd_dkv_f32"] <= 0
            or counts["flash_bwd_dq_tc"] or counts["flash_bwd_dkv_tc"]):
        fail(f"crucible (a): launches {counts}")
    add(counts)
    del rig
    gc.collect()

    # (b) the slice at full width
    full = serving_config()
    big = crucible_model(dataclasses.replace(full, dtype=torch.float32),
                         "(b) serving")
    gang_cfg = dataclasses.replace(full, n_layers=CRUCIBLE_GANG_LAYERS)
    print(f"crucible (b) gangs: the 154M's widths at {gang_cfg.n_layers} "
          f"layers, {gang_cfg.dtype}", flush=True)
    with ShardedSaveTimer() as timer:
        sched, res, rig, counts, wall = crucible_soak(
            fa, pa, "(b)", CRUCIBLE_FULL_CYCLES, tmp / "b", model=big,
            gang_cfg=gang_cfg)
    crucible_gates("crucible (b)", sched, res, rig, CRUCIBLE_FULL_CYCLES)
    if (counts["flash_fwd_f32"] <= 0 or counts["flash_fwd_tc"] <= 0
            or counts["paged_decode"] <= 0
            or counts["flash_bwd_dq_tc"] <= 0
            or counts["flash_bwd_dkv_tc"] <= 0
            or counts["flash_bwd_dq_f32"] or counts["flash_bwd_dkv_f32"]):
        fail(f"crucible (b): launches {counts}")
    saved = sum(b for b, _ in timer.saves)
    mean_ms = (sum(ms for _, ms in timer.saves) / len(timer.saves)
               if timer.saves else float("nan"))
    print(f"crucible (b) 154M (serving f32; gangs bf16, "
          f"{gang_cfg.n_layers} layers): {wall:.1f} s, "
          f"{len(timer.saves)} generations saved, {saved / 2 ** 20:.1f} "
          f"MiB in all ({saved / 2 ** 20 / max(len(timer.saves), 1):.1f} "
          f"MiB each), mean save {mean_ms:.0f} ms; {len(timer.restores)} "
          f"restores (step, ms) "
          f"{[(s, round(ms)) for s, ms in timer.restores]}; "
          f"step_deadline_s {rig.step_deadline_s}, hang_stall_s "
          f"{rig.hang_stall_s}; burn alerts {rig.burn.alerts_total}",
          flush=True)
    if not timer.saves or not timer.restores:
        fail("crucible (b): no generation saved or restored")
    add(counts)
    del rig, big
    gc.collect()

    # (c) determinism: the spec-fleet schedule twice, then its repro
    def spec_schedule():
        return Schedule(seed=11, cycles=14, events=[
            FaultEvent(id="warm-burst", kind="burst", at_cycle=1, n=6,
                       prompt_seed=31),
            FaultEvent(id="mid-burst", kind="burst", at_cycle=4, n=6,
                       prompt_seed=47),
            FaultEvent(id="decode-kill", kind="replica_kill", at_cycle=5,
                       replica_glob="d*"),
            FaultEvent(id="kv-squeeze", kind="kv_exhaust", at_cycle=6,
                       heal_after=12),
            FaultEvent(id="tail-burst", kind="burst", at_cycle=8, n=6,
                       prompt_seed=59)])

    spec_kw = dict(model=small, device="cuda", draft_source="ngram",
                   draft_len=3)
    records = []
    for i in range(2):
        sched = spec_schedule()
        zero_counts(fa)
        pa.launches = 0
        res, rig = cru.run_soak(sched, tmp / f"c{i}", **spec_kw)
        counts = {**flash_routes(fa), "paged_decode": pa.launches,
                  "flash_fwd": fa.launches}
        add(counts)
        bad = [m for _, v in res.violations for m in v]
        if bad or res.finished != res.submitted or res.submitted != 18:
            fail(f"crucible (c) run {i}: {res.finished}/{res.submitted} "
                 f"finished, violations {bad[:8]}")
        records.append(crucible_record(sched, rig))
    same = {k: records[0][k] == records[1][k] for k in records[0]}
    print(f"crucible (c) spec fleet (seed 11, 14 cycles, n-gram) twice: "
          f"equal {same}; fired {records[0]['fired']}; "
          f"{len(records[0]['tokens'])} token arrays, injections "
          f"{ {k: len(v) for k, v in records[0]['plans'].items()} }",
          flush=True)
    if not all(same.values()):
        fail(f"crucible (c): the two runs parted: {same}")
    repro = cru.write_repro(tmp / "c-repro.json", sched, res)
    res2, rig2 = cru.replay(repro, tmp / "c-replay", **spec_kw)
    replayed = [(e.id, e.fired_cycle) for e in rig2.schedule.events]
    original = [(e.id, e.fired_cycle) for e in sched.events]
    print(f"crucible (c) repro replayed: fired {replayed} (original "
          f"{original}), violations {len(res2.violations)}", flush=True)
    if replayed != original or res2.violations:
        fail("crucible (c): the replay fired apart from the original")
    del rig, rig2
    gc.collect()
    print(f"crucible phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return routes, f32_routes


#: the sp phase: two worker processes on the one card, a gloo group
#: (NCCL refuses two ranks on one device), SP_STEPS steps of the 154M
SP_WORLD = 2
SP_STEPS = 3
#: seconds the sp workers may take, start to join; each collective's
#: own timeout (the rendezvous contract's barrier timeout) is shorter
SP_TIMEOUT_S = 420
SP_BARRIER_S = 180
#: sp losses against phase_train's single-device losses of the same
#: weights and batches, bf16: the ring merges its hops in f32 and rounds
#: p per hop against another running max, and the gradients are summed
#: over the two ranks in f32 before their bf16 rounding; AdamW's early
#: steps are near lr * sign(g), so a gradient entry near zero may take
#: the other sign.  Same-path reruns part by a few thousandths
#: (RESUME_TOL); held at under 1% of losses 5 to 11
SP_LOSS_TOL = 5e-2
#: the f32 card steps over the mesh against one CPU process, gradients
#: relative to each tensor's largest entry (summation order only)
SP_GRAD_TOL = 1e-4


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def kernel_counts(fa) -> dict:
    """K1 (normalized and block entry), K3 and K4 launches by route."""
    return {"fwd_tc": fa.tc_launches, "fwd_f32": fa.launches - fa.tc_launches,
            "block_tc": fa.block_tc_launches,
            "block_f32": fa.block_launches - fa.block_tc_launches,
            "dq_tc": fa.dq_tc_launches,
            "dq_f32": fa.dq_launches - fa.dq_tc_launches,
            "dkv_tc": fa.dkv_tc_launches,
            "dkv_f32": fa.dkv_launches - fa.dkv_tc_launches}


def profiled_step(step, params, opt, batch):
    """One train step under torch.profiler: (params, opt, loss, wall ms,
    device ms: the summed time of every kernel and copy it ran)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, batch)
        loss = float(loss)
        wall = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
    dev_us = sum(getattr(e, "self_device_time_total", 0.0)
                 for e in prof.key_averages())
    return params, opt, loss, wall, (dev_us / 1e3 if dev_us > 0 else None)


def sp_worker(rank: int, world: int, port: int, job_path: str,
              out_dir: str) -> None:
    """One rank of the sp phase, on the card: the group from the
    rendezvous contract (gloo), then (a) the f32 small ring step, (d)
    the f32 small dp step, (b) SP_STEPS steps of the 154M over sp=2 by
    ring, (c) one 154M Ulysses step.  Writes its results, or its
    traceback, under ``out_dir``."""
    import traceback

    import torch.distributed as dist
    out = Path(out_dir)
    try:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from k8s_dra_driver_tpu_torch.models.transformer import (
            make_train_step)
        from k8s_dra_driver_tpu_torch.ops import flash_attention as fa
        from k8s_dra_driver_tpu_torch.parallel import rendezvous
        from k8s_dra_driver_tpu_torch.parallel.mesh import MeshSpec, make_mesh
        env = {"TPU_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
               "TPU_WORKER_ID": str(rank), "TPU_NUM_WORKERS": str(world),
               "TPU_RENDEZVOUS_BARRIER_TIMEOUT_S": str(SP_BARRIER_S)}
        rendezvous.initialize(rendezvous.spec_from_env(env), backend="gloo")
        res = {"psum": rendezvous.gang_psum(float(rank + 1))}
        job = torch.load(job_path, weights_only=False)
        sp_mesh = make_mesh(MeshSpec(sp=world), device="cuda")
        dp_mesh = make_mesh(MeshSpec(dp=world), device="cuda")
        res["coords"] = sp_mesh.coords
        small = small_train_config()
        for key, mesh in (("a", sp_mesh), ("d", dp_mesh)):
            zero_counts(fa)
            loss, params, grads = small_step(small, "cuda", job["tokens"],
                                             job["seg"], mesh=mesh)
            res[key] = dict(loss=loss, params=params, grads=grads,
                            counts=kernel_counts(fa))

        cfg = serving_config()
        step, init_state = make_train_step(cfg, device="cuda", mesh=sp_mesh)
        params, opt = init_state(torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.reset_peak_memory_stats()
        res["b"] = []
        for batch in job["batches"]:
            zero_counts(fa)
            params, opt, loss, wall, dev = profiled_step(step, params, opt,
                                                         batch)
            res["b"].append(dict(loss=loss, wall_ms=wall, device_ms=dev,
                                 counts=kernel_counts(fa)))
        res["peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
        del params, opt, step, init_state
        torch.cuda.empty_cache()

        step, init_state = make_train_step(
            dataclasses.replace(cfg, seq_parallel="ulysses"), device="cuda",
            mesh=sp_mesh)
        params, opt = init_state(torch.Generator(device="cuda").manual_seed(0))
        zero_counts(fa)
        params, opt, loss, wall, dev = profiled_step(step, params, opt,
                                                     job["batches"][0])
        res["c"] = dict(loss=loss, wall_ms=wall, device_ms=dev,
                        counts=kernel_counts(fa))
        torch.save(res, out / f"rank{rank}.pt")
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


#: (e): a ring peer wedged (SIGSTOP) and one killed (SIGKILL), each
#: on its own pair of ranks of the f32 small ring step over sp=2, at
#: this rendezvous deadline (every mesh group's timeout)
SP_WEDGE_BARRIER_S = 10
#: seconds rank 0 may take to exit nonzero after its peer's signal
SP_WEDGE_BOUND_S = 50
#: seconds the pairs may take to reach the victims' first steps
SP_WEDGE_START_S = 120
SP_WEDGE_SIGNALS = (("SIGSTOP", signal.SIGSTOP), ("SIGKILL", signal.SIGKILL))

SP_WEDGE_CHILD = """
import sys
import chip_smoke
chip_smoke.sp_wedge_worker(sys.argv[1])
"""


def sp_wedge_worker(go: str) -> None:
    """A rank of (e): the CUDA context made, ``READY``; once ``go``
    exists, the group from the rendezvous contract in the environment
    (gloo) and the f32 small ring step over MeshSpec(sp=2) again and
    again on the card, ``STEP i done`` after each, until its parent ends
    it (or, left alone, exits 0 after SP_WEDGE_START_S +
    SP_WEDGE_BOUND_S)."""
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from k8s_dra_driver_tpu_torch.models.transformer import make_train_step
    from k8s_dra_driver_tpu_torch.parallel import rendezvous
    from k8s_dra_driver_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    torch.zeros(1, device="cuda")
    print("READY", flush=True)
    end = time.monotonic() + SP_WEDGE_START_S
    while not Path(go).exists():
        if time.monotonic() > end:
            fail("sp (e) worker: never told to start")
        time.sleep(0.02)
    rendezvous.initialize(rendezvous.spec_from_env(), backend="gloo")
    mesh = make_mesh(MeshSpec(sp=2), device="cuda")
    cfg = small_train_config()
    tokens, seg = small_batch(cfg)
    step, init_state = make_train_step(cfg, device="cuda", mesh=mesh)
    params, opt = init_state(torch.Generator().manual_seed(3))
    i = 0
    while time.monotonic() < end + SP_WEDGE_BOUND_S:
        params, opt, loss = step(params, opt, tokens, seg)
        print(f"STEP {i} done loss {float(loss):.6f}", flush=True)
        i += 1


def sp_wedge(tmp: Path) -> None:
    """(e): for each of SP_WEDGE_SIGNALS a pair of sp_wedge_worker
    ranks sharing the card, both pairs at once; rank 1 gets the signal
    after its first step's line, and rank 0 must exit nonzero within
    SP_WEDGE_BOUND_S of it, its stderr naming ``MeshPeerError``, the
    ``sp`` axis and the deadline.  Prints the case's wall and each
    survivor's seconds to error; any miss fails the run."""
    t0 = time.perf_counter()
    root = Path(__file__).resolve().parent
    pairs, procs = {}, []
    try:
        for name, sig in SP_WEDGE_SIGNALS:
            port = free_port()
            ranks = []
            for r in range(2):
                env = dict(os.environ,
                           TPU_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                           TPU_WORKER_ID=str(r), TPU_NUM_WORKERS="2",
                           TPU_RENDEZVOUS_BARRIER_TIMEOUT_S=str(
                               SP_WEDGE_BARRIER_S),
                           PYTHONPATH=os.pathsep.join(
                               [str(root)] + [p for p in os.environ.get(
                                   "PYTHONPATH", "").split(os.pathsep)
                                   if p]))
                out, err = tmp / f"{name}-{r}.out", tmp / f"{name}-{r}.err"
                # a session of its own: a stopped rank in this script's
                # process group would let the kernel hang the whole
                # group up (SIGHUP) once that group is orphaned
                with open(out, "w") as fo, open(err, "w") as fe:
                    proc = subprocess.Popen(
                        [sys.executable, "-c", SP_WEDGE_CHILD,
                         str(tmp / f"go-{name}")], cwd=root, env=env,
                        stdout=fo, stderr=fe, start_new_session=True)
                procs.append(proc)
                ranks.append((proc, out, err))
            pairs[name] = dict(sig=sig, ranks=ranks)

        def tails(name: str) -> str:
            return "".join(f"\n--- rank {r} (rc {proc.poll()}):\n"
                           f"{err.read_text()[-3000:]}"
                           for r, (proc, _, err) in
                           enumerate(pairs[name]["ranks"]))

        # the CUDA contexts made, each pair stands its group up at once
        deadline = time.monotonic() + SP_WEDGE_START_S
        for name, pair in pairs.items():
            for proc, out, _ in pair["ranks"]:
                while "READY" not in out.read_text():
                    if proc.poll() is not None or time.monotonic() > deadline:
                        fail(f"sp (e) {name}: a rank never got ready"
                             + tails(name))
                    time.sleep(0.02)
            (tmp / f"go-{name}").touch()
        waiting = dict(pairs)
        while waiting:
            for name, pair in list(waiting.items()):
                victim, out, _ = pair["ranks"][1]
                if "STEP 0 done" in out.read_text():
                    if pair["ranks"][0][0].poll() is not None:
                        fail(f"sp (e) {name}: rank 0 ended before the "
                             f"signal" + tails(name))
                    os.kill(victim.pid, pair["sig"])
                    pair["t_sig"] = time.monotonic()
                    del waiting[name]
                elif victim.poll() is not None or time.monotonic() > deadline:
                    fail(f"sp (e) {name}: rank 1 never finished a step"
                         + tails(name))
            time.sleep(0.01)
        waiting = dict(pairs)
        while waiting:
            for name, pair in list(waiting.items()):
                survivor = pair["ranks"][0][0]
                if survivor.poll() is not None:
                    pair["took"] = time.monotonic() - pair["t_sig"]
                    del waiting[name]
                elif time.monotonic() > pair["t_sig"] + SP_WEDGE_BOUND_S:
                    fail(f"sp (e) {name}: rank 0 hung past "
                         f"{SP_WEDGE_BOUND_S} s after rank 1's {name}"
                         + tails(name))
            time.sleep(0.01)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait(30)
    for name, pair in pairs.items():
        survivor, _, err = pair["ranks"][0]
        text = err.read_text()
        found = re.search(r"MeshPeerError: (mesh axis 'sp'[^\n]*)", text)
        ok = (survivor.returncode != 0 and found is not None
              and f"deadline of {SP_WEDGE_BARRIER_S} s" in found.group(1))
        print(f"sp (e) ring peer {name} after its first step, f32 small "
              f"MeshSpec(sp=2) on the card over gloo, rendezvous deadline "
              f"{SP_WEDGE_BARRIER_S} s: rank 0 exited rc "
              f"{survivor.returncode} {pair['took']:.2f} s after the signal "
              f"(bound {SP_WEDGE_BOUND_S} s), stderr: "
              f"{found.group(0)[:300] if found else '(no MeshPeerError)'} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"sp (e) {name}: rank 0 did not fail in-band" + tails(name))
    print(f"sp (e) wall: {time.perf_counter() - t0:.2f} s (both pairs at "
          f"once, beside the workers of (a)-(d), from their start to the "
          f"last survivor's exit)", flush=True)


def grad_errors(grads, want) -> float:
    """Largest gradient difference relative to each tensor's largest
    entry."""
    return max(float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
               for g, w in zip(grads, want))


def phase_sp_train(fa, record: dict) -> dict:
    """Context-parallel training on the card: SP_WORLD worker processes
    share the one card, stand their group up through the port's
    ``rendezvous.initialize`` (gloo: NCCL refuses two ranks on one
    device, so every exchange is staged through host memory), check
    ``gang_psum``, then run (a) an f32 2-layer ring step against one CPU
    process's step (plain versions) of the same weights and batch, (b)
    SP_STEPS steps of the 154M at full width over MeshSpec(sp=2) by ring
    on phase_train's weights and first batches, losses against
    phase_train's, K1-block/K3/K4 launches 8 a step on rank 0 and 16 on
    rank 1 on the tensor cores and no normalized K1, (c) one Ulysses
    step likewise (the normalized K1, K3, K4 8 a step on each rank), (d)
    the f32 small step over MeshSpec(dp=2) as (a), (e) a ring peer of
    the f32 small step wedged, then killed (:func:`sp_wedge`, beside
    the workers of (a)-(d)), its survivor failing in-band by the
    mesh's deadline.  Any failure, hang
    past SP_TIMEOUT_S or disagreement fails the run.  Returns the main
    path's launches summed over ranks (the ring steps of (b); the f32
    block route from (a))."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    small = small_train_config()
    tokens, seg = small_batch(small)
    def beside():
        # meanwhile, the one-process CPU step (a) and (d) are held to,
        # and (e)'s pairs
        out = small_step(small, "cpu", tokens, seg)
        with tempfile.TemporaryDirectory() as tmp:
            sp_wedge(Path(tmp))
        return out

    ranks, (cpu_loss, cpu_params, cpu_grads), took = run_workers(
        sp_worker, SP_WORLD, dict(tokens=tokens, seg=seg,
                                  batches=record["batches"][:SP_STEPS]),
        "sp", SP_TIMEOUT_S, beside)
    print(f"sp gang: {SP_WORLD} worker processes on the one card, group "
          f"from rendezvous.initialize (backend gloo: NCCL refuses two "
          f"ranks on one device), gang_psum {[r['psum'] for r in ranks]} "
          f"(expected {SP_WORLD * (SP_WORLD + 1) / 2}); workers took "
          f"{took:.1f} s start to join", flush=True)

    layers = small.n_layers
    small_want = {
        # ring: rank 0 runs its diagonal hop, rank 1 both hops
        "a": [dict(block_f32=layers * (r + 1), dq_f32=layers * (r + 1),
                   dkv_f32=layers * (r + 1)) for r in range(SP_WORLD)],
        # dp: the single-device path, one normalized K1 a layer
        "d": [dict(fwd_f32=layers, dq_f32=layers, dkv_f32=layers)
              for _ in range(SP_WORLD)]}
    for key, label in (("a", "MeshSpec(sp=2) ring"),
                       ("d", "MeshSpec(dp=2, sp=1)")):
        for r, res in enumerate(ranks):
            got = res[key]
            loss_rel = abs(got["loss"] - cpu_loss) / abs(cpu_loss)
            gerr = grad_errors(got["grads"], cpu_grads)
            strict, noisy, n_noisy = step_param_errors(got["params"],
                                                       cpu_params, cpu_grads)
            counts = {k: v for k, v in got["counts"].items() if v}
            ok = (loss_rel <= STEP_LOSS_RTOL and gerr <= SP_GRAD_TOL
                  and strict <= STEP_PARAM_ATOL and noisy <= 2 * 3e-4
                  and counts == small_want[key][r])
            print(f"sp ({key}) f32 small step {label}, rank {r} on the card "
                  f"(kernels) vs one CPU process (plain): loss "
                  f"{got['loss']:.7f} vs {cpu_loss:.7f} (rel {loss_rel:.3g}, "
                  f"tol {STEP_LOSS_RTOL}); grads max rel {gerr:.3g} (tol "
                  f"{SP_GRAD_TOL}); params max|d| {strict:.3g} (tol "
                  f"{STEP_PARAM_ATOL}), {n_noisy} noise-band entries max|d| "
                  f"{noisy:.3g}; launches {counts} (expected "
                  f"{small_want[key][r]}) {'ok' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                fail(f"sp ({key}) small step disagrees on rank {r}")

    ref = record["losses"]
    layers = serving_config().n_layers
    for r, res in enumerate(ranks):
        hops = r + 1
        want = dict(block_tc=layers * hops, dq_tc=layers * hops,
                    dkv_tc=layers * hops)
        for i, st in enumerate(res["b"]):
            counts = {k: v for k, v in st["counts"].items() if v}
            gap = abs(st["loss"] - ref[i])
            ok = gap <= SP_LOSS_TOL and counts == want
            print(f"sp (b) 154M B={TRAIN_B} T={TRAIN_T} bf16 MeshSpec(sp=2) "
                  f"ring, step {i + 1} rank {r}: loss {st['loss']:.5f} vs "
                  f"single-device {ref[i]:.5f} (|d| {gap:.3g}, tol "
                  f"{SP_LOSS_TOL}); wall {st['wall_ms']:.1f} ms, device "
                  f"{fmt(st['device_ms'])} ms (kernels and copies; two "
                  f"processes sharing one card, host-staged gloo exchange, "
                  f"under the profiler); launches {counts} (expected "
                  f"{want}) {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"sp (b) step {i + 1} disagrees on rank {r}")
        print(f"sp (b) rank {r}: peak device memory {res['peak_gb']:.2f} "
              f"GiB", flush=True)
        st = res["c"]
        counts = {k: v for k, v in st["counts"].items() if v}
        want = dict(fwd_tc=layers, dq_tc=layers, dkv_tc=layers)
        gap = abs(st["loss"] - ref[0])
        ok = gap <= SP_LOSS_TOL and counts == want
        print(f"sp (c) 154M Ulysses step 1 rank {r}: loss {st['loss']:.5f} vs "
              f"single-device {ref[0]:.5f} (|d| {gap:.3g}, tol "
              f"{SP_LOSS_TOL}); wall {st['wall_ms']:.1f} ms, device "
              f"{fmt(st['device_ms'])} ms (same setup); launches {counts} "
              f"(expected {want}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"sp (c) Ulysses step disagrees on rank {r}")
    total = {k: sum(st["counts"][k] for res in ranks for st in res["b"])
             for k in ranks[0]["b"][0]["counts"]}
    total["block_f32"] = sum(res["a"]["counts"]["block_f32"]
                             for res in ranks)
    return total


def zero_moe_counts(fa, gm) -> None:
    zero_counts(fa)
    for name in gm.launches:
        gm.launches[name] = 0
    gm.tc_launches = gm.dw_tc_launches = 0


def moe_counts(fa, gm) -> dict:
    return {**train_counts(fa), **gm.launches}


def moe_step_launches(cfg, steps: int) -> dict:
    """Exact launches of ``steps`` gmm train steps: per layer K5 twice
    forward and twice for dx, K6 twice (dw of w_in and w_out), K1, K3
    and K4 once."""
    n = cfg.n_layers * steps
    return {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n,
            "gmm": 4 * n, "gmm_dw": 2 * n}


def phase_moe_train_small(fa, gm) -> dict:
    """One f32 AdamW step of a 2-layer, 4-expert gmm config with both
    router aux losses on the card (K1, K3-K6) and on the CPU (plain
    versions), from the same parameters and tokens; parameters
    compared by :func:`step_param_errors`.  Returns the card step's
    K3/K4 launches by route (all on the f32 route)."""
    from k8s_dra_driver_tpu_torch.models.transformer import (
        TransformerConfig, make_train_step, named_tensors)
    cfg = TransformerConfig(vocab=512, d_model=256, n_layers=2, n_heads=4,
                            n_kv_heads=2, d_head=64, d_ff=512, n_experts=4,
                            top_k=2, max_seq=256, dtype=torch.float32,
                            moe_dispatch="gmm", aux_loss_weight=0.01,
                            router_z_weight=0.001)
    tokens = np.random.default_rng(7).integers(0, cfg.vocab, (2, 256))
    results = {}
    for device in ("cuda", "cpu"):
        step, init_state = make_train_step(cfg, device=device)
        params, opt = init_state(torch.Generator().manual_seed(3))
        before = [t.detach().cpu().clone() for _, t in named_tensors(params)]
        zero_moe_counts(fa, gm)
        params, opt, loss = step(params, opt, tokens.astype(np.int32))
        leaves = named_tensors(params)
        missing = [n for n, t in leaves if t.grad is None]
        if missing:
            fail(f"MoE train step on {device}: no gradient for {missing}")
        after = [t.detach().cpu() for _, t in leaves]
        still = [n for (n, _), a, b in zip(leaves, after, before)
                 if torch.equal(a, b)]
        if still:
            fail(f"MoE train step on {device}: {still} did not move")
        if device == "cuda":
            routes = require_routes(fa, "train MoE f32 small step", 0,
                                    cfg.n_layers)
            routes.update(require_gmm_routes(
                gm, "train MoE f32 small step", 0, 4 * cfg.n_layers, 0,
                2 * cfg.n_layers))
        results[device] = (float(loss), after,
                           [t.grad.detach().cpu() for _, t in leaves],
                           moe_counts(fa, gm), [n for n, _ in leaves])
    (l_c, p_c, _, counts, names), (l_h, p_h, g_h, _, _) = (results["cuda"],
                                                          results["cpu"])
    want = moe_step_launches(cfg, 1)
    if counts != want:
        fail(f"small MoE step launched {counts}, expected {want}")
    loss_rel = abs(l_c - l_h) / abs(l_h)
    strict, noisy, n_noisy = step_param_errors(p_c, p_h, g_h)
    ok = (loss_rel <= STEP_LOSS_RTOL and strict <= STEP_PARAM_ATOL
          and noisy <= 2 * 3e-4)
    print(f"train MoE f32 small step (E=4 top_k=2 gmm, aux on), card "
          f"(kernels) vs CPU (plain): loss {l_c:.7f} vs {l_h:.7f} (rel "
          f"{loss_rel:.3g}, tol {STEP_LOSS_RTOL}); params max|d| "
          f"{strict:.3g} (tol {STEP_PARAM_ATOL}), {n_noisy} noise-band "
          f"entries max|d| {noisy:.3g} (tol 6e-4); all {len(names)} "
          f"tensors moved, router included; launches {counts} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("the card's f32 MoE train step disagrees with the CPU's")
    return routes


def map_params(params, fn):
    """The parameter tree (a dict with a ``layers`` list of dicts) with
    ``fn`` applied to every tensor."""
    return {k: ([{n: fn(t) for n, t in layer.items()} for layer in v]
                if k == "layers" else fn(v)) for k, v in params.items()}


def phase_moe_train(fa, gm, tmp: Path, record: dict) -> dict:
    """moe_heavy at full width with gmm dispatch: TRAIN_STEPS AdamW
    steps of MOE_B x MOE_T tokens from a token file through
    ``BatchLoader``, load-balance loss weight MOE_AUX_WEIGHT, with the
    kernel counters zeroed just before and read just after; then three
    steps again from the same seed (bitwise the same losses and
    parameters: no step is order-dependent); then one bf16 forward of
    the initial parameters under dense dispatch against gmm.  Returns
    the steps' launches; ``record`` gets the losses and the first
    SP_STEPS batches, which the mesh phase trains again over ep=2."""
    from k8s_dra_driver_tpu_torch.models.data import (BatchLoader,
                                                      load_token_file,
                                                      write_token_file)
    from k8s_dra_driver_tpu_torch.models.transformer import (
        forward, make_train_step, named_tensors)
    cfg = moe_heavy_config(aux_loss_weight=MOE_AUX_WEIGHT)
    motif = np.random.default_rng(1).integers(0, cfg.vocab, 32)
    corpus = np.tile(motif, 2 * MOE_B * MOE_T // 32)
    path = write_token_file(corpus, tmp / "moe_corpus.bin", cfg.vocab)

    def loader():
        return BatchLoader(load_token_file(path, cfg.vocab), batch=MOE_B,
                           seq_len=MOE_T, seed=0)

    step, init_state = make_train_step(cfg, device="cuda")
    params, opt = init_state(torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(t.numel() for _, t in named_tensors(params))
    initial = map_params(params, lambda t: t.detach().clone())
    data = loader()
    first = None
    losses, walls = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_moe_counts(fa, gm)
    record["batches"] = []
    for _ in range(TRAIN_STEPS):
        batch = next(data)
        first = batch if first is None else first
        if len(record["batches"]) < SP_STEPS:
            record["batches"].append(batch)
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))          # waits for the step
        walls.append(time.perf_counter() - t0)
    record["losses"] = losses
    counts = moe_counts(fa, gm)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = 1e3 * sum(walls[1:]) / (len(walls) - 1)
    want = moe_step_launches(cfg, TRAIN_STEPS)
    print(f"train moe_heavy ({n_params} parameters, E={cfg.n_experts} "
          f"top_k={cfg.top_k} gmm, aux weight {MOE_AUX_WEIGHT}) "
          f"B={MOE_B} T={MOE_T} bf16: losses "
          f"{[round(x, 5) for x in losses]}; step wall ms "
          f"{[round(1e3 * w, 1) for w in walls]} (mean of steps 2-"
          f"{TRAIN_STEPS}: {step_ms:.1f} ms = "
          f"{MOE_B * MOE_T / (step_ms / 1e3):.0f} tokens/s); peak device "
          f"memory {peak_gb:.2f} GiB; kernel launches {counts} (expected "
          f"{want})", flush=True)
    if not all(np.isfinite(losses)):
        fail(f"non-finite MoE training loss: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"MoE training loss did not fall: {losses}")
    if counts != want:
        fail(f"MoE training launched {counts}, expected {want}")
    counts.update(require_routes(fa, "train moe_heavy",
                                 cfg.n_layers * TRAIN_STEPS, 0))
    counts.update(require_gmm_routes(gm, "train moe_heavy",
                                     want["gmm"], 0, want["gmm_dw"], 0))

    # the same three steps again from the same seed
    params2, opt2 = init_state(torch.Generator(device="cuda").manual_seed(0))
    data2 = loader()
    again = []
    for _ in range(3):
        params2, opt2, loss = step(params2, opt2, next(data2))
        again.append(float(loss))
    ref = [t.detach().clone() for _, t in named_tensors(params2)]
    del params2, opt2
    params3, opt3 = init_state(torch.Generator(device="cuda").manual_seed(0))
    data3 = loader()
    for _ in range(3):
        params3, opt3, _ = step(params3, opt3, next(data3))
    same = all(torch.equal(a, t.detach())
               for a, (_, t) in zip(ref, named_tensors(params3)))
    same_losses = again == losses[:3]
    print(f"train moe_heavy repeat: three steps from the same seed, losses "
          f"{[round(x, 5) for x in again]} equal to the run's first three "
          f"{same_losses}; parameters of two repeats bitwise equal {same}",
          flush=True)
    del params3, opt3, ref, params, opt
    if not (same and same_losses):
        fail("the MoE train step is not deterministic")

    # gmm against dense dispatch on the initial parameters
    toks = torch.as_tensor(first[:2], device="cuda")
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    as_f32 = map_params(initial, lambda t: t.float())
    gaps = {}
    with torch.no_grad():
        for label, c, p in (("f32", f32, as_f32), ("bf16", cfg, initial)):
            got = forward(p, toks, c).float()
            dense = forward(p, toks, dataclasses.replace(
                c, moe_dispatch="dense")).float()
            if not torch.isfinite(got).all():
                fail(f"non-finite gmm logits ({label})")
            gaps[label] = ((got - dense).abs().max().item(),
                           max(1.0, dense.abs().max().item()))
        ties = router_ties(initial, toks, cfg)
    torch.cuda.synchronize()
    (err, scale), (err_bf, _) = gaps["f32"], gaps["bf16"]
    ok = err <= DISPATCH_TOL * scale
    print(f"moe_heavy forward B=2 T={MOE_T}, gmm (K5) vs dense dispatch "
          f"(no kernel in the MLP), initial weights in f32: logits max|d| "
          f"{err:.4g} (tol {DISPATCH_TOL} x max(1, max|dense| "
          f"{scale:.3g})) {'ok' if ok else 'FAIL'}; in bf16 max|d| "
          f"{err_bf:.4g} with {ties} of {toks.numel()} tokens tied at the "
          f"k-th gate in layer 0 (not held: dense mixes every tied "
          f"expert, gmm exactly top_k)", flush=True)
    if not ok:
        fail("gmm dispatch disagrees with dense dispatch at moe_heavy")
    return counts


def router_ties(params, toks, cfg) -> int:
    """Tokens whose layer-0 router keeps more than top_k experts (a tie
    at the k-th gate)."""
    from k8s_dra_driver_tpu_torch.models import transformer as tt
    layer = params["layers"][0]
    x = tt.take_rows(params["embed"], toks, cfg.dtype)
    x = x + tt._attention(tt.rms_norm(x, layer["ln1"]), layer, cfg)
    gates = tt._router_gates(tt.rms_norm(x, layer["ln2"]), layer, cfg)[0]
    return int(((gates > 0).sum(-1) > cfg.top_k).sum())


def phase_moe_serving(fa, pa, gm) -> dict:
    """One contiguous ServingEngine drain of the s8_r24 traffic at
    moe_heavy's widths (vocab 1024; served with dense dispatch, K1 for
    prefill), every greedy stream held to a teacher-forced forward
    under gmm dispatch (K5).  In f32: in bf16 the router's logits tie
    at the k-th gate for about 1% of tokens, where the serving dispatch
    (dense: every tied expert) and the training one (gmm: exactly
    top_k) of the JAX package part by whole logits, so a bf16 stream
    cannot be held to a gmm forward.  Returns the drain's launches."""
    from k8s_dra_driver_tpu_torch.models.serving import ServingEngine
    from k8s_dra_driver_tpu_torch.models.transformer import init_params
    cfg = moe_heavy_config(dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(2),
                         device="cuda")
    reqs = s8_r24(cfg.vocab)
    zero_moe_counts(fa, gm)
    done, counts, _, _ = drain(ServingEngine, params, cfg, reqs, fa, pa,
                            "moe_heavy f32 contiguous", top_k=50)
    counts = {**counts, **{k: v for k, v in gm.launches.items()}}
    if counts["flash_fwd"] <= 0:
        fail("the MoE drain launched no flash kernel")
    gm.launches["gmm"] = gm.tc_launches = 0
    worst = teacher_forced(params, cfg, done, reqs)
    print(f"teacher-forced (moe_heavy f32, forward under gmm dispatch, K5 "
          f"launched {gm.launches['gmm']} times): worst gap {worst:.4f} "
          f"<= {TF_MARGIN}", flush=True)
    if gm.launches["gmm"] <= 0:
        fail("the MoE teacher-forced check launched no gmm kernel")
    require_gmm_routes(gm, "moe_heavy f32 teacher-forced check", 0,
                       gm.launches["gmm"], 0, 0)
    return counts


#: K1 at the 154M's tp=2 prefill on one rank's heads (8 of 16 query and
#: 2 of 4 KV heads; phase_multichip (b)), at the flagship forward of
#: graft_entry.entry() (phase_multichip (c)) and at the dryrun decode's
#: prefill on one rank's heads (phase_multichip (a)): phase_flash holds
#: K1 at each
TP_PREFILL_K1 = dict(b=8, t=96, h=8, h_kv=2, d=64)
#: K1 at the fills of phase_multichip (e)'s tp=2 engine on one rank's
#: heads, beside TP_PREFILL_K1 (B=8 T=96): the contiguous engine's
#: groups of one prompt length padded to its 8 slots, the paged
#: engine's one-request fills, at s8_r24's prompt lengths
TP_ENGINE_K1 = [dict(b=b, t=t, h=8, h_kv=2, d=64) for b in (8, 1)
                for t in (24, 48, 72, 96) if (b, t) != (8, 96)]
#: K1 at moe_heavy's tp=2 prefill on one rank's heads (2 of 4 query and
#: KV heads; phase_multichip (d), f32)
TP_MOE_PREFILL_K1 = dict(b=8, t=96, h=2, h_kv=2, d=64)
ENTRY_K1 = dict(b=4, t=256, h=8, h_kv=8, d=64)
DRYRUN_DECODE_K1 = dict(b=4, t=8, h=2, h_kv=1, d=8)


#: the mesh phase: worker processes on the one card (gloo), part (a)'s
#: ep x tp step on MESH_MOE_WORLD of them, (a)'s tp step and (b)-(d) on
#: SP_WORLD; the seconds each group may take, start to join
MESH_MOE_WORLD = 4
MESH_TIMEOUT_S = 480


def small_moe_config():
    """small_train_config made MoE with gmm dispatch (4 experts, top 2),
    the f32 config of the ep x tp card-vs-CPU step."""
    return dataclasses.replace(small_train_config(), n_experts=4, top_k=2,
                               moe_dispatch="gmm")


def mesh_counts(fa, gm) -> dict:
    """K1, K3, K4 (normalized entry), K5 and K6 launches by route, the
    nonzero ones."""
    routes = {**flash_routes(fa), "gmm_tc": gm.tc_launches,
              "gmm_f32": gm.launches["gmm"] - gm.tc_launches,
              "gmm_dw_tc": gm.dw_tc_launches,
              "gmm_dw_f32": gm.launches["gmm_dw"] - gm.dw_tc_launches}
    return {k: v for k, v in routes.items() if v}


def mesh_small_step(cfg, tokens, seg, mesh):
    """small_step over ``mesh``: one AdamW step of ``cfg`` from generator
    seed 3 on this rank's blocks; (loss, every parameter after the step
    and every summed gradient, gathered whole, on the host)."""
    from k8s_dra_driver_tpu_torch.models.transformer import (
        gather_params, grad_tree, make_train_step, named_tensors)
    step, init_state = make_train_step(cfg, device="cuda", mesh=mesh)
    params, opt = init_state(torch.Generator().manual_seed(3))
    params, opt, loss = step(params, opt, tokens, seg)
    grads = gather_params(grad_tree(params), cfg, mesh)
    whole = gather_params(params, cfg, mesh)
    return (float(loss), [t.cpu() for _, t in named_tensors(whole)],
            [g.cpu() for _, g in named_tensors(grads)])


def mesh_worker(rank: int, world: int, port: int, job_path: str,
                out_dir: str) -> None:
    """One rank of the mesh phase, on the card: the group from the
    rendezvous contract (gloo), then the job's parts in turn — "a_moe"
    (the f32 small MoE step over ep=2 x tp=2), "a_tp" (the f32 small
    step over tp=2), "b" (the 154M over tp=2), "c" (moe_heavy over ep=2)
    and "d" (the 154M over pp=2).  Writes its results, or its
    traceback, under ``out_dir``."""
    import traceback

    import torch.distributed as dist
    out = Path(out_dir)
    try:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from k8s_dra_driver_tpu_torch.models import transformer as tt
        from k8s_dra_driver_tpu_torch.ops import flash_attention as fa
        from k8s_dra_driver_tpu_torch.ops import gmm as gm
        from k8s_dra_driver_tpu_torch.parallel import rendezvous
        from k8s_dra_driver_tpu_torch.parallel.mesh import MeshSpec, make_mesh
        env = {"TPU_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
               "TPU_WORKER_ID": str(rank), "TPU_NUM_WORKERS": str(world),
               "TPU_RENDEZVOUS_BARRIER_TIMEOUT_S": str(SP_BARRIER_S)}
        rendezvous.initialize(rendezvous.spec_from_env(env), backend="gloo")
        res = {"psum": rendezvous.gang_psum(float(rank + 1))}
        job = torch.load(job_path, weights_only=False)
        for part in job["parts"]:
            if part in ("a_moe", "a_tp"):
                cfg = (small_moe_config() if part == "a_moe"
                       else small_train_config())
                mesh = make_mesh(MeshSpec(ep=2, tp=2) if part == "a_moe"
                                 else MeshSpec(tp=2), device="cuda")
                zero_moe_counts(fa, gm)
                loss, params, grads = mesh_small_step(
                    cfg, job["tokens"], job["seg"], mesh)
                res[part] = dict(loss=loss, params=params, grads=grads,
                                 counts=mesh_counts(fa, gm),
                                 coords=mesh.coords)
                continue
            if part == "c":
                cfg = moe_heavy_config(aux_loss_weight=MOE_AUX_WEIGHT)
                spec, batches = MeshSpec(ep=2), job["moe_batches"]
            else:
                cfg = serving_config()
                if part == "d":
                    cfg = dataclasses.replace(cfg, pp_stages=2)
                spec = MeshSpec(tp=2) if part == "b" else MeshSpec(pp=2)
                batches = job["batches"]
            mesh = make_mesh(spec, device="cuda")
            step, init_state = tt.make_train_step(cfg, device="cuda",
                                                  mesh=mesh)
            params, opt = init_state(
                torch.Generator(device="cuda").manual_seed(0))
            torch.cuda.reset_peak_memory_stats()
            steps, routed = [], []
            plain = tt._gmm_dispatch_combine

            def counted(xf, gate_vals, expert_ids, w_in, w_out, e, bm):
                # this rank's routed rows: its own experts', and the
                # dead group's (the last of the e groups)
                routed.append((int((expert_ids < e - 1).sum()),
                               int((expert_ids == e - 1).sum())))
                return plain(xf, gate_vals, expert_ids, w_in, w_out, e, bm)

            for i, batch in enumerate(batches):
                tt._gmm_dispatch_combine = counted if i == 0 else plain
                zero_moe_counts(fa, gm)
                params, opt, loss, wall, dev = profiled_step(
                    step, params, opt, batch)
                steps.append(dict(loss=loss, wall_ms=wall, device_ms=dev,
                                  counts=mesh_counts(fa, gm)))
            tt._gmm_dispatch_combine = plain
            res[part] = dict(
                steps=steps, coords=mesh.coords, routed=routed,
                peak_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
            del params, opt, step, init_state
            torch.cuda.empty_cache()
        torch.save(res, out / f"rank{rank}.pt")
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class Workers:
    """``world`` processes of ``target(rank, world, port, job_path,
    out_dir)`` on the card running ``job``, started at once; :meth:`join`
    waits for them."""

    def __init__(self, target, world: int, job: dict, label: str):
        import multiprocessing as mp
        self.world, self.label = world, label
        self.tmp = tempfile.TemporaryDirectory()
        job_path = Path(self.tmp.name) / "job.pt"
        torch.save(job, job_path)
        ctx = mp.get_context("spawn")
        port = free_port()
        self.t0 = time.perf_counter()
        self.procs = [ctx.Process(target=target,
                                  args=(r, world, port, str(job_path),
                                        self.tmp.name))
                      for r in range(world)]
        for proc in self.procs:
            proc.start()

    def join(self, timeout_s: float) -> tuple[list, float]:
        """(the ranks' results, seconds start to join); any failure, a
        hang past ``timeout_s`` from this call or a wrong ``gang_psum``
        fails the run."""
        tmp, world, label = Path(self.tmp.name), self.world, self.label
        deadline = time.monotonic() + timeout_s
        for proc in self.procs:
            proc.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, proc in enumerate(self.procs) if proc.is_alive()]
        for proc in self.procs:
            if proc.is_alive():
                proc.kill()
                proc.join(30)
        took = time.perf_counter() - self.t0
        errs = {r: (tmp / f"rank{r}.err").read_text()
                for r in range(world) if (tmp / f"rank{r}.err").exists()}
        codes = [proc.exitcode for proc in self.procs]
        if hung or errs or any(codes):
            fail(f"{label} workers failed: hung {hung} (timeout "
                 f"{timeout_s} s), exit codes {codes}\n"
                 + "\n".join(f"rank {r}:\n{e}" for r, e in errs.items()))
        ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                 for r in range(world)]
        self.tmp.cleanup()
        want = world * (world + 1) / 2
        if [r["psum"] for r in ranks] != [want] * world:
            fail(f"{label}: gang_psum {[r['psum'] for r in ranks]}")
        return ranks, took


def run_workers(target, world: int, job: dict, label: str, timeout_s: float,
                cpu_work=None):
    """``world`` processes of ``target(rank, world, port, job_path,
    out_dir)`` on the card running ``job``; while they run,
    ``cpu_work()`` (the CPU references) runs here.  Returns (the ranks'
    results, cpu_work's result, seconds start to join); any failure, a
    hang past ``timeout_s`` or a wrong ``gang_psum`` fails the run."""
    workers = Workers(target, world, job, label)
    extra = cpu_work() if cpu_work is not None else None
    ranks, took = workers.join(timeout_s)
    return ranks, extra, took


def phase_mesh_train(fa, gm, record: dict, moe_record: dict) -> dict:
    """Tensor, expert and pipeline parallelism on the card: worker
    processes share the one card and stand their group up through
    ``rendezvous.initialize`` (gloo: NCCL refuses two ranks on one
    device, so every collective is staged through host memory).

    (a) f32 2-layer steps against one CPU process's single-device step
    (plain versions) of the same weights and batch: small_train_config
    over MeshSpec(tp=2), and made MoE with gmm dispatch over
    MeshSpec(ep=2, tp=2) on four ranks; each rank's loss, its gradients
    and its parameters after the step, gathered whole, at phase_sp_train's
    tolerances, and exact f32-route launches.  (b) SP_STEPS steps of the
    154M bf16 over MeshSpec(tp=2) on phase_train's weights and batches,
    losses against phase_train's, K1/K3/K4 8 a step on each rank on the
    tensor cores (8 of the 16 heads).  (c) moe_heavy bf16 gmm over
    MeshSpec(ep=2) against phase_moe_train's losses, each rank's step
    the launches of moe_step_launches(cfg, 1) on the tensor cores (K5/K6
    over its 8 experts and the dead group), and each rank's live and
    dead-group rows.  (d) the 154M bf16 over MeshSpec(pp=2): GPipe, 4
    layers a stage, 2 S = 4 microbatches, the bubble ticks skipped, so
    K1/K3/K4 launch 4 x 4 = 16 times a step on each stage.  Returns the
    launches summed over ranks by route."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    card = card_line()
    small = small_train_config()
    tokens, seg = small_batch(small)
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    def small_refs():
        return {"a_tp": small_step(small, "cpu", tokens, seg),
                "a_moe": small_step(small_moe_config(), "cpu", tokens, seg)}

    def beside():
        # the CPU references, then the SP_WORLD group of (a) tp and
        # (b)-(d), while the ep x tp group runs
        refs = small_refs()
        ranks, _, took = run_workers(
            mesh_worker, SP_WORLD,
            dict(parts=["a_tp", "b", "c", "d"], tokens=tokens, seg=seg,
                 batches=record["batches"][:SP_STEPS],
                 moe_batches=moe_record["batches"][:SP_STEPS]),
            "mesh (a) tp, (b)-(d)", MESH_TIMEOUT_S)
        return refs, ranks, took

    moe_ranks, (cpu, ranks, took), took_a = run_workers(
        mesh_worker, MESH_MOE_WORLD,
        dict(parts=["a_moe"], tokens=tokens, seg=seg), "mesh (a) ep x tp",
        MESH_TIMEOUT_S, beside)
    print(f"mesh gang: {MESH_MOE_WORLD} and {SP_WORLD} worker processes "
          f"side by side on the one card, groups from "
          f"rendezvous.initialize (gloo), took {took_a:.1f} s (the "
          f"{MESH_MOE_WORLD}, joined after the {SP_WORLD}) and {took:.1f} s "
          f"start to join; {card}", flush=True)

    layers = small.n_layers
    f32_flash = {"flash_fwd_f32": layers, "flash_bwd_dq_f32": layers,
                 "flash_bwd_dkv_f32": layers}
    for part, label, per_rank, want in (
            ("a_tp", "MeshSpec(tp=2)", ranks, f32_flash),
            ("a_moe", "MeshSpec(ep=2, tp=2) MoE gmm", moe_ranks,
             {**f32_flash, "gmm_f32": 4 * layers, "gmm_dw_f32": 2 * layers})):
        cpu_loss, cpu_params, cpu_grads = cpu[part]
        for r, res in enumerate(per_rank):
            got = res[part]
            loss_rel = abs(got["loss"] - cpu_loss) / abs(cpu_loss)
            gerr = grad_errors(got["grads"], cpu_grads)
            strict, noisy, n_noisy = step_param_errors(got["params"],
                                                       cpu_params, cpu_grads)
            ok = (loss_rel <= STEP_LOSS_RTOL and gerr <= SP_GRAD_TOL
                  and strict <= STEP_PARAM_ATOL and noisy <= 2 * 3e-4
                  and got["counts"] == want)
            print(f"mesh (a) f32 small step {label}, rank {r} "
                  f"{got['coords']} on the card (kernels) vs one CPU process "
                  f"(plain): loss {got['loss']:.7f} vs {cpu_loss:.7f} (rel "
                  f"{loss_rel:.3g}, tol {STEP_LOSS_RTOL}); gathered grads "
                  f"max rel {gerr:.3g} (tol {SP_GRAD_TOL}); gathered params "
                  f"max|d| {strict:.3g} (tol {STEP_PARAM_ATOL}), {n_noisy} "
                  f"noise-band entries max|d| {noisy:.3g}; launches "
                  f"{got['counts']} (expected {want}) "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"mesh (a) {label} disagrees on rank {r}")
            add(got["counts"])

    n = serving_config().n_layers
    heavy = moe_heavy_config()
    moe_want = moe_step_launches(heavy, 1)
    for part, label, ref, want in (
            ("b", "154M bf16 MeshSpec(tp=2), 8 of 16 heads a rank",
             record["losses"], {"flash_fwd_tc": n, "flash_bwd_dq_tc": n,
                                "flash_bwd_dkv_tc": n}),
            ("c", "moe_heavy bf16 gmm MeshSpec(ep=2), 8 experts a rank",
             moe_record["losses"],
             {"flash_fwd_tc": moe_want["flash_fwd"],
              "flash_bwd_dq_tc": moe_want["flash_bwd_dq"],
              "flash_bwd_dkv_tc": moe_want["flash_bwd_dkv"],
              "gmm_tc": moe_want["gmm"], "gmm_dw_tc": moe_want["gmm_dw"]}),
            ("d", "154M bf16 MeshSpec(pp=2) GPipe, 4 layers a stage, 4 "
             "microbatches", record["losses"],
             {"flash_fwd_tc": 16, "flash_bwd_dq_tc": 16,
              "flash_bwd_dkv_tc": 16})):
        for r, res in enumerate(ranks):
            got = res[part]
            for i, st in enumerate(got["steps"]):
                gap = abs(st["loss"] - ref[i])
                ok = gap <= SP_LOSS_TOL and st["counts"] == want
                print(f"mesh ({part}) {label}, step {i + 1} rank {r} "
                      f"{got['coords']}: loss {st['loss']:.5f} vs "
                      f"single-device {ref[i]:.5f} (|d| {gap:.3g}, tol "
                      f"{SP_LOSS_TOL}); wall {st['wall_ms']:.1f} ms, device "
                      f"{fmt(st['device_ms'])} ms (kernels and copies; two "
                      f"processes sharing one card, host-staged gloo "
                      f"collectives, under the profiler); launches "
                      f"{st['counts']} (expected {want}) "
                      f"{'ok' if ok else 'FAIL'}; {card}", flush=True)
                if not ok:
                    fail(f"mesh ({part}) step {i + 1} disagrees on rank {r}")
                add(st["counts"])
            if part == "c":
                live = sum(a for a, _ in got["routed"])
                dead = sum(b for _, b in got["routed"])
                print(f"mesh (c) rank {r}: step 1 routed {live} rows to its "
                      f"own experts and {dead} to the dead group over "
                      f"{len(got['routed'])} layers ({live + dead} gathered "
                      f"token slots)", flush=True)
                if live + dead != len(got["routed"]) * MOE_B * MOE_T \
                        * heavy.top_k:
                    fail(f"mesh (c): rank {r} routed {live} + {dead} rows")
            print(f"mesh ({part}) rank {r}: peak device memory "
                  f"{got['peak_gb']:.2f} GiB", flush=True)
    return total


#: the multichip phase: the dryrun's ranks, the 154M's tp ranks and its
#: traffic (numpy seed 0), the weights' generator seed on the card, the
#: seconds each group may take, start to join
MULTICHIP_WORLD = 8
MULTICHIP_TP = 2
MULTICHIP_PROMPTS, MULTICHIP_PROMPT_LEN, MULTICHIP_NEW = 8, 96, 32
MULTICHIP_SEED = 0
MULTICHIP_TIMEOUT_S = 420
#: a dryrun run's first loss against the single-device f32 step
MULTICHIP_LOSS_RTOL = 1e-4
#: the f32 tp prefill logits against the single-process ones, relative
#: to their largest magnitude (partial sums over heads and hidden units
#: added in another order)
MULTICHIP_F32_TOL = 1e-4
#: (b)'s runs on each rank, in each dtype: the plain one, then what tp
#: decode once refused: the int8 KV cache, int8 weights (K7), the paged
#: pool read by K2, LoRA rows
MULTICHIP_VARIANTS = ("plain", "int8kv", "quant", "paged", "lora")
#: (b)'s paged pool: blocks of 16 tokens
MULTICHIP_BS = 16
#: (b)'s LoRA pool: three adapters of rank 8 (``make_adapter`` seeds
#: 1-3); the 8 rows on slots 0-3, twice
MULTICHIP_LORA = dict(rank=8, seeds=(1, 2, 3), rows=(0, 1, 2, 3, 0, 1, 2, 3))
#: the int8 KV cache's f32 first-step logits against the twin's,
#: relative to their largest magnitude: the CPU tests' FWD_TOL for the
#: same variant (tests/torch_a0.py; an entry that lands on the other
#: side of an int8 rounding step moves the logits more than a partial
#: sum added in another order does)
MULTICHIP_INT8KV_STEP_TOL = 2e-4
#: (d): moe_heavy in f32 over ep=2 x tp=2, four ranks
MULTICHIP_MOE_SPEC = dict(ep=2, tp=2)
MULTICHIP_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
#: each group's runs, (variant, dtype name), in order: (b) every variant
#: in f32, then in bf16; (d) moe_heavy's plain run in f32
MULTICHIP_RUNS = [(v, name) for name in MULTICHIP_DTYPES
                  for v in MULTICHIP_VARIANTS]
MULTICHIP_MOE_RUNS = [("plain", "f32")]
#: (e): ``ServingEngine(..., mesh=)`` at tp=2 on the 154M, its drains of
#: s8_r24 (the first MULTICHIP_ENGINE_REQUESTS requests), f32 then bf16
#: (no runs: no (e) ranks, as before the engine took a mesh)
MULTICHIP_ENGINE_MODES = {
    "step": {}, "fused": {"chain_steps": FUSED_CHAIN},
    "ngram": {"draft_source": "ngram", "draft_len": SPEC_DRAFT_LEN},
    "paged": {"kv_layout": "paged"}}
MULTICHIP_ENGINE_RUNS = [("engine", name) for name in MULTICHIP_DTYPES]
MULTICHIP_ENGINE_REQUESTS = 24


def engine_launches(dtype_name: str, n_layers: int, labels: dict) -> dict:
    """A tp rank's launches in one engine drain, from its dispatch
    labels and the code: K1 once a layer in each fresh fill
    (``prefill_adopt_rows``, and the paged engine's ``prefill`` of a
    fresh transient cache) on the dtype's route; K2 once a layer a paged
    step (``paged_decode_step_rows``, the kernel read by default on the
    card); nothing else (prefix-hit fills, windows and contiguous steps
    read the cache through plain ops, and no weight is int8)."""
    k1 = "flash_fwd_f32" if dtype_name == "f32" else "flash_fwd_tc"
    want = {k1: n_layers * (labels.get("prefill_adopt_rows", 0)
                            + labels.get("prefill", 0))}
    if labels.get("paged_decode_step_rows"):
        want["paged_decode"] = n_layers * labels["paged_decode_step_rows"]
    return want


def multichip_engine(dtype_name: str, reqs, mesh=None, counts=None,
                     zero=None) -> dict:
    """Each of MULTICHIP_ENGINE_MODES' drains of ``reqs`` by a
    ``ServingEngine`` of 8 slots (engine ``top_k`` 50) over the 154M in
    the dtype: this rank's ``shard_params`` blocks under ``mesh``, the
    whole weights without one (the single-process twin, whose fused
    mode replays ``FusedBlockGraph``s).  Returns, by mode, each
    request's stream, ``counts()`` after the drain (``zero()`` before
    it), the dispatch labels, the generated tokens, the wall, the KV
    heads of the engine's cache or pool and the paged engine's block
    tables' shape (the rows and pages K2 reads: phase 4 holds K2 at
    them, :func:`paged_tp_cases`)."""
    from k8s_dra_driver_tpu_torch.models.serving import ServingEngine
    from k8s_dra_driver_tpu_torch.models.transformer import shard_params
    from k8s_dra_driver_tpu_torch.utils import dispatch
    cfg, whole = multichip_weights(MULTICHIP_DTYPES[dtype_name])
    params = whole if mesh is None else shard_params(whole, cfg, mesh)
    del whole
    out = {}
    for mode, kw in MULTICHIP_ENGINE_MODES.items():
        eng = ServingEngine(params, cfg, slots=8, top_k=50, device="cuda",
                            mesh=mesh, **kw)
        for r in reqs:
            eng.submit(r)
        if zero is not None:
            zero()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with dispatch.track() as t, torch.no_grad():
            done = eng.run()
        torch.cuda.synchronize()
        kv = eng.pool if eng.cache is None else eng.cache
        out[mode] = dict(
            streams={f.uid: f.tokens for f in done},
            counts=counts() if counts is not None else None,
            labels=dict(t.by_label), wall_s=time.perf_counter() - t0,
            tokens=sum(len(f.tokens) - f.n_prompt for f in done),
            kv_heads=kv.k[0].shape[2], graphs=eng._graphs is not None,
            tables=(None if eng.cache is not None
                    else tuple(eng._table.shape)))
        del eng, kv
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return out


def multichip_launches(variant: str, dtype_name: str, n_layers: int,
                       steps: int) -> dict:
    """A tp rank's launches in one run of (b)'s ``variant`` (or (d)'s,
    "plain") of ``n_layers`` layers and ``steps`` decode steps, from the
    code: K1 once a layer in the prefill, on the dtype's route; K2 once
    a layer a paged step; K7a 49 times a step on int8 weights (the six
    projections of each of the 154M's 8 layers and the unembedding,
    each a call of at most 64 rows; the 768-row prefill takes the
    einsum), on the tensor cores in bf16; nothing else."""
    want = {("flash_fwd_f32" if dtype_name == "f32" else "flash_fwd_tc"):
            n_layers}
    if variant == "paged":
        want["paged_decode"] = n_layers * steps
    if variant == "quant":
        want["int8_matmul"] = (6 * n_layers + 1) * steps
        if dtype_name == "bf16":
            want["int8_tc"] = want["int8_matmul"]
    return want


def multichip_prompts(vocab: int) -> np.ndarray:
    """The 154M tp traffic: MULTICHIP_PROMPTS prompts of
    MULTICHIP_PROMPT_LEN tokens from numpy seed 0."""
    return np.random.default_rng(0).integers(
        0, vocab, (MULTICHIP_PROMPTS, MULTICHIP_PROMPT_LEN))


def multichip_weights(dtype):
    """(cfg, whole weights on the card): the 154M in ``dtype`` from
    generator seed MULTICHIP_SEED on the card (bf16 weights are the f32
    ones rounded)."""
    from k8s_dra_driver_tpu_torch.models.transformer import init_params
    cfg = dataclasses.replace(serving_config(), dtype=dtype)
    return cfg, init_params(
        cfg, torch.Generator(device="cuda").manual_seed(MULTICHIP_SEED),
        device="cuda")


def multichip_worker(rank: int, world: int, port: int, job_path: str,
                     out_dir: str) -> None:
    """One rank of part (b), (d) or (e): the group from the rendezvous
    contract (gloo), ``MeshSpec(**job["spec"])``, then each of the job's
    runs, (variant, dtype name), on its blocks of the job's model
    (:func:`multichip_setup`): ``prefill`` of the job's prompts and
    greedy steps under ``mesh=`` (:func:`multichip_decode`), or for the
    "engine" variant the job's requests drained by
    ``ServingEngine(..., mesh=)`` in each mode
    (:func:`multichip_engine`).  Writes, by run, the prefill logits, the
    first step's logits and int8 cache (f32), the tokens, K1's launches
    by route after the prefill and K1, K2 and K7's after the steps, its
    cache's KV heads, its experts a layer (MoE) and the wall a decode
    step (the engine's drains, by mode), or its traceback, under
    ``out_dir``."""
    import traceback

    import torch.distributed as dist
    out = Path(out_dir)
    try:
        child_setup()
        from k8s_dra_driver_tpu_torch.models import quant as qm
        from k8s_dra_driver_tpu_torch.ops import flash_attention as fa
        from k8s_dra_driver_tpu_torch.ops import paged_attention as pa
        from k8s_dra_driver_tpu_torch.parallel.mesh import MeshSpec, make_mesh
        res = {"psum": worker_group(rank, world, port)}
        job = torch.load(job_path, weights_only=False)
        mesh = make_mesh(MeshSpec(**job["spec"]), device="cuda")
        prompts = torch.from_numpy(job["prompts"]).cuda()
        res["runs"] = {}
        for variant, name in job["runs"]:
            if variant == "engine":
                res["runs"][(variant, name)] = dict(
                    coords=mesh.coords, modes=multichip_engine(
                        name, job["requests"], mesh,
                        counts=lambda: tp_counts(fa, pa, qm),
                        zero=lambda: zero_tp_counts(fa, pa, qm)))
                continue
            cfg, params, lora = multichip_setup(
                variant, MULTICHIP_DTYPES[name], mesh, job["model"])
            zero_tp_counts(fa, pa, qm)
            got = multichip_decode(variant, cfg, params, prompts, mesh,
                                   lora, counts=lambda: tp_counts(
                                       fa, pa, qm))
            if name == "bf16":
                del got["step_logits"], got["int8"]
            experts = (params["layers"][0]["w_in"].shape[0]
                       if cfg.n_experts else None)
            res["runs"][(variant, name)] = dict(
                coords=mesh.coords, counts=tp_counts(fa, pa, qm),
                experts=experts, **got)
            del params, lora
            torch.cuda.empty_cache()
        torch.save(res, out / f"rank{rank}.pt")
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def worker_group(rank: int, world: int, port: int) -> float:
    """A worker's default group from the rendezvous contract (gloo), at
    phase_sp_train's barrier deadline; returns its ``gang_psum``."""
    from k8s_dra_driver_tpu_torch.parallel import rendezvous
    env = {"TPU_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
           "TPU_WORKER_ID": str(rank), "TPU_NUM_WORKERS": str(world),
           "TPU_RENDEZVOUS_BARRIER_TIMEOUT_S": str(SP_BARRIER_S)}
    rendezvous.initialize(rendezvous.spec_from_env(env), backend="gloo")
    return rendezvous.gang_psum(float(rank + 1))


def zero_tp_counts(fa, pa, qm) -> None:
    """K1's, K2's and K7's launch counters to 0."""
    zero_counts(fa)
    pa.launches = 0
    for name in qm.launches:
        qm.launches[name] = 0
    qm.tc_launches = 0


def tp_counts(fa, pa, qm) -> dict:
    """The nonzero launches of K1 by route, of K2 and of K7 (its entries,
    and those on the tensor cores) since :func:`zero_tp_counts`."""
    routes = {**flash_routes(fa), "paged_decode": pa.launches,
              "int8_matmul": qm.launches["int8_matmul"],
              "int8_bmm": qm.launches["int8_bmm"],
              "int8_tc": qm.tc_launches}
    return {k: v for k, v in routes.items() if v}


def multichip_setup(variant: str, dtype, mesh=None, model: str = "154m"):
    """(cfg, params, lora) of ``variant`` in ``dtype``: the weights of
    ``model``, (b)'s 154M (:func:`multichip_weights`) or (d)'s moe_heavy
    (:func:`multichip_moe_weights`, f32), this rank's blocks under
    ``mesh`` (``shard_params``), int8 through ``quantize_params`` first
    for "quant", the int8 KV cache in the config for "int8kv", and for
    "lora" an ``AdapterPool`` of MULTICHIP_LORA's adapters with each
    row's slot id (this rank's cut of its buffers under ``mesh``,
    ``shard_lora_buffers``)."""
    from k8s_dra_driver_tpu_torch.models.quant import quantize_params
    from k8s_dra_driver_tpu_torch.models.transformer import shard_params
    from k8s_dra_driver_tpu_torch.serving_lora.pool import (
        AdapterManifest, AdapterPool, make_adapter, shard_lora_buffers)
    cfg, whole = (multichip_weights(dtype) if model == "154m"
                  else multichip_moe_weights())
    if variant == "int8kv":
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    if variant == "quant":
        whole = quantize_params(whole, cfg)
    params = whole if mesh is None else shard_params(whole, cfg, mesh)
    del whole
    lora = None
    if variant == "lora":
        rank, seeds = MULTICHIP_LORA["rank"], MULTICHIP_LORA["seeds"]
        pool = AdapterPool(cfg, rank, len(seeds), device="cuda")
        for seed in seeds:
            pool.register(AdapterManifest(
                f"adapter{seed}", rank,
                source=make_adapter(cfg, rank, seed)))
        slots = [0] + [pool.acquire(f"adapter{seed}") for seed in seeds]
        rows = torch.tensor([slots[r] for r in MULTICHIP_LORA["rows"]],
                            device="cuda")
        lora = (rows, pool.buffers if mesh is None
                else shard_lora_buffers(pool.buffers, mesh))
    return cfg, params, lora


def multichip_decode(variant: str, cfg, params, prompts, mesh=None,
                     lora=None, counts=None) -> dict:
    """``prefill`` of ``prompts`` into a fresh cache, then
    MULTICHIP_NEW - 1 greedy steps: ``decode_step_rows`` (with ``lora``),
    or for "paged" ``paged_decode_step_rows`` with K2's read
    (``use_kernel=True``) on a pool of MULTICHIP_BS-token blocks the
    prefill's rows were adopted into (``paged_adopt_blocks``, as a
    paged engine's fill lands).  Under ``mesh`` on this rank's blocks,
    without one the single-process twin.  Returns the prefill logits,
    the first step's logits (both f32, on the host), for "int8kv" the
    int8 k and v of every layer after that step (on the host), the
    tokens, the KV heads a layer holds, ``counts()`` after the prefill
    and the wall a step."""
    from k8s_dra_driver_tpu_torch.models import decode as dm
    b, t = prompts.shape
    total = t + MULTICHIP_NEW
    with torch.no_grad():
        cache = dm.init_cache(cfg, b, total, device="cuda", mesh=mesh)
        logits, cache = dm.prefill(params, prompts, cfg, cache, mesh=mesh)
        prefill_counts = counts() if counts is not None else None
        kv_heads = cache.k[0].shape[2]
        if variant == "paged":
            bs = MULTICHIP_BS
            per_row = total // bs
            pool = dm.init_paged_pool(cfg, b * per_row + 1, bs,
                                      device="cuda", mesh=mesh)
            tables = (1 + torch.arange(b * per_row, dtype=torch.int32,
                                       device="cuda")).reshape(b, per_row)
            for r in range(b):
                row = dm.KVCache(k=[a[r:r + 1] for a in cache.k],
                                 v=[a[r:r + 1] for a in cache.v])
                dm.paged_adopt_blocks(pool, row, tables[r, :t // bs], 0,
                                      t // bs)
            del cache

            def step(tok, pos):
                return dm.paged_decode_step_rows(
                    params, tok[:, None], cfg, pool, tables, pos,
                    use_kernel=True, mesh=mesh)[0]
        else:
            def step(tok, pos):
                return dm.decode_step_rows(params, tok[:, None], cfg, cache,
                                           pos, lora=lora, mesh=mesh)[0]
        tok = logits[:, -1].argmax(dim=-1)
        pos = torch.full((b,), t, device="cuda")
        toks, first, int8 = [tok], None, None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MULTICHIP_NEW - 1):
            lg = step(tok, pos)
            if first is None:
                first = lg.float().cpu()
                if variant == "int8kv":
                    int8 = [a[:, :t + 1].cpu() for a in cache.k + cache.v]
            tok, pos = lg.argmax(dim=-1), pos + 1
            toks.append(tok)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / (MULTICHIP_NEW - 1)
    return dict(logits=logits.float().cpu(), step_logits=first, int8=int8,
                tokens=torch.stack(toks, dim=1).cpu(), kv_heads=kv_heads,
                prefill_counts=prefill_counts, step_ms=step_ms)


def multichip_refs(prompts: np.ndarray, model: str, runs) -> dict:
    """The single-process references on the card of ``model``'s
    ``runs``, (variant, dtype name), by run: for "plain" the prefill
    logits of a fresh cache and ``greedy_generate``'s tokens on the
    whole weights; for the engine :func:`multichip_engine`'s drains
    without a mesh; for the others :func:`multichip_decode`'s twin
    without a mesh on the whole weights (and whole adapter buffers)."""
    from k8s_dra_driver_tpu_torch.models import decode as dm
    toks = torch.from_numpy(prompts).cuda()
    b, t = toks.shape
    refs = {}
    for variant, name in runs:
        if variant == "engine":
            refs[(variant, name)] = multichip_engine(
                name, s8_r24(serving_config().vocab)[
                    :MULTICHIP_ENGINE_REQUESTS])
            continue
        cfg, params, lora = multichip_setup(variant, MULTICHIP_DTYPES[name],
                                            model=model)
        if variant == "plain":
            with torch.no_grad():
                cache = dm.init_cache(cfg, b, t + MULTICHIP_NEW,
                                      device="cuda")
                logits, _ = dm.forward_with_cache(params, toks, cfg, cache,
                                                  first_chunk=True)
                tokens = dm.greedy_generate(params, toks, cfg, MULTICHIP_NEW,
                                            max_seq=t + MULTICHIP_NEW)
            refs[(variant, name)] = dict(logits=logits.float().cpu(),
                                         tokens=tokens[:, t:].cpu())
            del cache, logits
        else:
            refs[(variant, name)] = multichip_decode(variant, cfg, params,
                                                     toks, lora=lora)
        del params, lora
        torch.cuda.empty_cache()
    return refs


def multichip_moe_weights():
    """(cfg, whole weights on the card): moe_heavy in f32 from generator
    seed MULTICHIP_SEED on the card."""
    from k8s_dra_driver_tpu_torch.models.transformer import init_params
    cfg = moe_heavy_config(dtype=torch.float32)
    return cfg, init_params(
        cfg, torch.Generator(device="cuda").manual_seed(MULTICHIP_SEED),
        device="cuda")


def int8_steps_off(got: list, ref: list, coords: dict,
                   kv_local: int) -> str:
    """How a tp rank's int8 k and v (every layer, after the first step)
    differ from its heads of the single-process twin's: the entries off
    and the most int8 steps any is off."""
    lo = coords["tp"] * kv_local
    off = most = total = 0
    for a, b in zip(got, ref):
        d = (a.int() - b[:, :, lo:lo + kv_local].int()).abs()
        off += int(d.count_nonzero())
        most = max(most, int(d.max()))
        total += d.numel()
    return (f"int8 k/v entries off the twin's {off} of {total}, at most "
            f"{most} step(s)")


def dryrun_routes(launches: dict) -> dict:
    """A dryrun report's launch counters (graft_entry's) by route."""
    out = {}
    for name in ("flash_fwd", "flash_fwd_block", "flash_bwd_dq",
                 "flash_bwd_dkv", "gmm", "gmm_dw"):
        out[f"{name}_tc"] = launches[f"{name}_tc"]
        out[f"{name}_f32"] = launches[name] - launches[f"{name}_tc"]
    return out


def dryrun_single_losses(ge) -> list:
    """Each dryrun run's first loss from one process's single-device f32
    step on the card, on the weights and batch every rank starts from."""
    from k8s_dra_driver_tpu_torch.models.transformer import make_train_step
    losses = []
    for run in ge.dryrun_runs(MULTICHIP_WORLD):
        step, init_state = make_train_step(run.cfg, device="cuda")
        params, opt = init_state(
            torch.Generator().manual_seed(ge.SEEDS["params"]))
        _, _, loss = step(params, opt,
                          ge.dryrun_tokens(run.cfg, run.batch, run.seq))
        losses.append(float(loss))
        del params, opt
    return losses


#: what each dryrun run must launch on every rank (by route, > 0), f32
#: throughout: the ring's hops (K1's block entry) and Ulysses' and the
#: pipeline stages' normalized K1, K3/K4 in each backward, K5/K6 under
#: gmm
DRYRUN_REQUIRED = {
    "ring, capacity MoE, remat": ("flash_fwd_block_f32", "flash_bwd_dq_f32",
                                  "flash_bwd_dkv_f32"),
    "Ulysses, GQA, dense MoE": ("flash_fwd_f32", "flash_bwd_dq_f32",
                                "flash_bwd_dkv_f32"),
    "ring, dropless gmm MoE": ("flash_fwd_block_f32", "flash_bwd_dq_f32",
                               "flash_bwd_dkv_f32", "gmm_f32",
                               "gmm_dw_f32"),
    "pipeline pp=4 x dp=2": ("flash_fwd_f32", "flash_bwd_dq_f32",
                             "flash_bwd_dkv_f32"),
}


def phase_multichip(fa) -> dict:
    """The multichip certification on the card (module docstring, 20a):
    (b)'s two tp ranks, (d)'s four ep x tp ranks and (e)'s two engine
    ranks are spawned first, side by side; while they run, this process
    computes (b)'s, (d)'s and (e)'s references, then runs (a),
    ``dryrun_multichip(8)`` (its eight ranks, each in a session of its
    own, the kernel library already built), and the single-device f32
    steps; (c) last.  Returns the launches summed over the ranks of (a),
    (b), (d) and (e) and of (c), by route (K2 and K7 by entry)."""
    from k8s_dra_driver_tpu_torch import graft_entry as ge
    from k8s_dra_driver_tpu_torch.ops import paged_attention as pa
    from k8s_dra_driver_tpu_torch.parallel.mesh import MeshSpec
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    card = card_line()
    spec = MeshSpec.infer(MULTICHIP_WORLD)
    cfg154 = serving_config()
    prompts = multichip_prompts(cfg154.vocab)
    moe_cfg = moe_heavy_config()
    moe_prompts = multichip_prompts(moe_cfg.vocab)
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    def beside():
        dims = (dict(fa.dim_launches), dict(pa.dim_launches))
        refs = multichip_refs(prompts, "154m",
                              MULTICHIP_RUNS + MULTICHIP_ENGINE_RUNS)
        moe_ref = multichip_refs(moe_prompts, "moe_heavy",
                                 MULTICHIP_MOE_RUNS)[("plain", "f32")]
        t0 = time.perf_counter()
        try:
            reports = ge.dryrun_multichip(MULTICHIP_WORLD, device="cuda",
                                          timeout_s=MULTICHIP_TIMEOUT_S)
        except RuntimeError as e:
            fail(f"multichip (a): {e}")
        took = time.perf_counter() - t0
        single = dryrun_single_losses(ge)
        # the references are no main path: the launches by head dim
        # stay the main paths'
        for table, saved in zip((fa.dim_launches, pa.dim_launches), dims):
            table.clear()
            table.update(saved)
        return refs, moe_ref, reports, took, single

    moe_world = MULTICHIP_MOE_SPEC["ep"] * MULTICHIP_MOE_SPEC["tp"]
    moe_workers = Workers(multichip_worker, moe_world, dict(
        prompts=moe_prompts, spec=MULTICHIP_MOE_SPEC, model="moe_heavy",
        runs=MULTICHIP_MOE_RUNS), "multichip (d)")
    engine_reqs = s8_r24(cfg154.vocab)[:MULTICHIP_ENGINE_REQUESTS]
    engine_workers = (Workers(multichip_worker, MULTICHIP_TP, dict(
        prompts=prompts, spec=dict(tp=MULTICHIP_TP), model="154m",
        runs=MULTICHIP_ENGINE_RUNS, requests=engine_reqs), "multichip (e)")
        if MULTICHIP_ENGINE_RUNS else None)
    ranks, (refs, moe_ref, reports, took_a, single), took_b = run_workers(
        multichip_worker, MULTICHIP_TP, dict(
            prompts=prompts, spec=dict(tp=MULTICHIP_TP), model="154m",
            runs=MULTICHIP_RUNS), "multichip (b)", MULTICHIP_TIMEOUT_S,
        beside)
    moe_ranks, took_d = moe_workers.join(MULTICHIP_TIMEOUT_S)
    engine_ranks, took_e = (engine_workers.join(MULTICHIP_TIMEOUT_S)
                            if engine_workers is not None else ([], 0.0))
    print(f"multichip gang: dryrun_multichip({MULTICHIP_WORLD}) took "
          f"{took_a:.1f} s (eight rank processes, gloo, beside (b), (d) "
          f"and (e)); (b)'s {MULTICHIP_TP} tp ranks {took_b:.1f} s, (d)'s "
          f"{moe_world} ep x tp ranks {took_d:.1f} s and (e)'s "
          f"{MULTICHIP_TP} engine ranks {took_e:.1f} s start to join, side "
          f"by side; {card}", flush=True)

    # (a): the JAX dryrun's runs and its serving half
    runs = ge.dryrun_runs(MULTICHIP_WORLD)
    for i, run in enumerate(runs):
        first = reports[0]["runs"][i]
        for rep in reports:
            got = rep["runs"][i]
            if not np.allclose(got["losses"], first["losses"], rtol=1e-6,
                               atol=0.0):
                fail(f"multichip (a) {run.label}: rank {rep['rank']}'s "
                     f"losses {got['losses']} differ from rank 0's "
                     f"{first['losses']}")
        rel = abs(first["losses"][0] - single[i]) / abs(single[i])
        ok = (rel <= MULTICHIP_LOSS_RTOL
              and all(np.isfinite(first["losses"]))
              and first["losses"][-1] < first["losses"][0])
        print(f"multichip (a) {run.label} on {run.spec}, batch "
              f"[{run.batch}, {run.seq}] f32: losses "
              f"{[round(x, 6) for x in first['losses']]} (every rank "
              f"equal); first loss vs one process's single-device f32 step "
              f"on the card {single[i]:.7f} (rel {rel:.3g}, tol "
              f"{MULTICHIP_LOSS_RTOL}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"multichip (a) {run.label} disagrees")
    for rep in reports:
        by_run = {}
        for run, got in zip(runs, rep["runs"]):
            routes = dryrun_routes(got["launches"])
            by_run[run.label] = {k: v for k, v in routes.items() if v}
            missing = [k for k in DRYRUN_REQUIRED[run.label] if not routes[k]]
            on_tc = [k for k, v in routes.items() if k.endswith("_tc") and v]
            if missing or on_tc:
                fail(f"multichip (a) rank {rep['rank']} {run.label}: no "
                     f"launch of {missing}, tensor-core launches {on_tc} "
                     f"(f32 runs)")
            add(routes)
        dec = dryrun_routes(rep["decode"]["launches"])
        add(dec)
        print(f"multichip (a) rank {rep['rank']} "
              f"{rep['runs'][0]['coords']}: launches by route {by_run}; "
              f"decode {({k: v for k, v in dec.items() if v})}", flush=True)
        want_dec = {k: 0 for k in dec}
        want_dec["flash_fwd_f32"] = ge.decode_config(spec).n_layers
        if dec != want_dec:
            fail(f"multichip (a) rank {rep['rank']}: decode launches {dec}, "
                 f"expected {want_dec} (K1 once a layer in the prefill)")
        if rep["decode"]["tokens"] != reports[0]["decode"]["tokens"]:
            fail(f"multichip (a) rank {rep['rank']}: decode tokens differ")
    print(f"multichip (a) tp-sharded prefill + per-row decode on "
          f"{spec}: tokens "
          f"{reports[0]['decode']['tokens']} equal greedy_generate's on "
          f"every rank ok", flush=True)

    # (b): the 154M over tp=2, each variant in f32 and bf16
    n = cfg154.n_layers
    steps = MULTICHIP_NEW - 1
    kv_local = cfg154.kv_heads // MULTICHIP_TP
    for variant in MULTICHIP_VARIANTS:
        f32_logits = refs[(variant, "f32")]["logits"]
        gap = (refs[(variant, "bf16")]["logits"]
               - f32_logits).abs().max().item()
        bf16_tol = 2 * gap
        print(f"multichip (b) {variant} single process, bf16 vs f32 "
              f"prefill logits: max|d| {gap:.4g} (largest |logit| "
              f"{f32_logits.abs().max().item():.4g}); the bf16 tp "
              f"tolerance is twice it, {bf16_tol:.4g}", flush=True)
        for r, res in enumerate(ranks):
            for name in ("f32", "bf16"):
                got, ref = res["runs"][(variant, name)], refs[(variant, name)]
                k1 = "flash_fwd_f32" if name == "f32" else "flash_fwd_tc"
                want = multichip_launches(variant, name, n, steps)
                err = (got["logits"] - ref["logits"]).abs().max().item()
                scale = ref["logits"].abs().max().item()
                same = int((got["tokens"] == ref["tokens"]).all(dim=1).sum())
                agree = int((got["tokens"] == ref["tokens"]).sum())
                n_rows = len(ref["tokens"])
                if name == "f32":
                    ok = err <= MULTICHIP_F32_TOL * scale and same == n_rows
                    held = (f"prefill logits max|d| {err:.3g} (tol "
                            f"{MULTICHIP_F32_TOL} x {scale:.4g}); streams "
                            f"equal {same}/{n_rows} (gated)")
                    if variant != "plain":
                        serr = (got["step_logits"] - ref["step_logits"]
                                ).abs().max().item()
                        sscale = ref["step_logits"].abs().max().item()
                        stol = (MULTICHIP_INT8KV_STEP_TOL
                                if variant == "int8kv" else MULTICHIP_F32_TOL)
                        ok = ok and serr <= stol * sscale
                        held += (f"; first step's logits max|d| {serr:.3g} "
                                 f"(tol {stol} x {sscale:.4g})")
                        if variant == "int8kv":
                            held += "; " + int8_steps_off(
                                got["int8"], ref["int8"], got["coords"],
                                kv_local)
                else:
                    ok = err <= bf16_tol
                    held = (f"prefill logits max|d| {err:.4g} (tol "
                            f"{bf16_tol:.4g}); streams equal {same}/"
                            f"{n_rows}, tokens {agree}/"
                            f"{ref['tokens'].numel()} (printed, not gated)")
                ok = (ok and got["prefill_counts"] == {k1: n}
                      and got["counts"] == want
                      and got["kv_heads"] == kv_local)
                print(f"multichip (b) 154M {variant} {name} "
                      f"MeshSpec(tp={MULTICHIP_TP}) rank {r} "
                      f"{got['coords']}, {got['kv_heads']} of "
                      f"{cfg154.kv_heads} KV heads a rank, "
                      f"{MULTICHIP_PROMPTS} prompts of "
                      f"{MULTICHIP_PROMPT_LEN} + {MULTICHIP_NEW} greedy "
                      f"tokens vs the single process's "
                      f"{'greedy_generate' if variant == 'plain' else 'twin'}"
                      f": {held}; K1 launches in the prefill "
                      f"{got['prefill_counts']}, K1/K2/K7 after the steps "
                      f"{got['counts']} (expected {want}); wall "
                      f"{got['step_ms']:.1f} ms a token (host-staged gloo "
                      f"on one card, beside (a)'s and (d)'s ranks and the "
                      f"mesh phase's: not a scaling number) "
                      f"{'ok' if ok else 'FAIL'}; {card}", flush=True)
                if not ok:
                    fail(f"multichip (b) {variant} {name} disagrees on rank "
                         f"{r}")
                add(got["counts"])

    # (d): moe_heavy f32 over ep=2 x tp=2
    want = multichip_launches("plain", "f32", moe_cfg.n_layers, steps)
    for r, res in enumerate(moe_ranks):
        got = res["runs"][("plain", "f32")]
        err = (got["logits"] - moe_ref["logits"]).abs().max().item()
        scale = moe_ref["logits"].abs().max().item()
        same = int((got["tokens"] == moe_ref["tokens"]).all(dim=1).sum())
        n_rows = len(moe_ref["tokens"])
        ok = (err <= MULTICHIP_F32_TOL * scale and same == n_rows
              and got["prefill_counts"] == {"flash_fwd_f32":
                                            moe_cfg.n_layers}
              and got["counts"] == want
              and got["kv_heads"] == moe_cfg.kv_heads
              // MULTICHIP_MOE_SPEC["tp"]
              and got["experts"] == moe_cfg.n_experts
              // MULTICHIP_MOE_SPEC["ep"])
        print(f"multichip (d) moe_heavy f32 MeshSpec(ep="
              f"{MULTICHIP_MOE_SPEC['ep']}, tp={MULTICHIP_MOE_SPEC['tp']}) "
              f"rank {r} {got['coords']}, {got['experts']} of "
              f"{moe_cfg.n_experts} experts and {got['kv_heads']} of "
              f"{moe_cfg.kv_heads} KV heads a rank, dense dispatch, "
              f"{MULTICHIP_PROMPTS} prompts of {MULTICHIP_PROMPT_LEN} + "
              f"{MULTICHIP_NEW} greedy tokens vs single-process "
              f"greedy_generate: prefill logits max|d| {err:.3g} (tol "
              f"{MULTICHIP_F32_TOL} x {scale:.4g}); streams equal "
              f"{same}/{n_rows} (gated); K1 launches in the prefill "
              f"{got['prefill_counts']}, after the steps {got['counts']} "
              f"(expected {want}); wall {got['step_ms']:.1f} ms a token "
              f"{'ok' if ok else 'FAIL'}; {card}", flush=True)
        if not ok:
            fail(f"multichip (d) disagrees on rank {r}")
        add(got["counts"])

    # (e): ServingEngine(mesh=) over tp=2, s8_r24 in each mode
    for _, name in MULTICHIP_ENGINE_RUNS:
        for mode in MULTICHIP_ENGINE_MODES:
            ref = refs[("engine", name)][mode]["streams"]
            for r, res in enumerate(engine_ranks):
                got = res["runs"][("engine", name)]["modes"][mode]
                first = engine_ranks[0]["runs"][("engine", name)]["modes"][
                    mode]["streams"]
                lens = {q.uid: len(q.prompt) + q.max_new
                        for q in engine_reqs}
                streams = got["streams"]
                whole = sum(len(streams.get(u, ())) == m
                            for u, m in lens.items())
                same = sum(u in streams and u in ref
                           and np.array_equal(streams[u], ref[u])
                           for u in lens)
                ranks_same = streams.keys() == first.keys() and all(
                    np.array_equal(streams[u], first[u]) for u in streams)
                want = engine_launches(name, cfg154.n_layers, got["labels"])
                n = len(engine_reqs)
                tables = (8, cfg154.max_seq // MULTICHIP_BS)
                ok = (whole == n and ranks_same
                      and got["counts"] == want
                      and got["kv_heads"] == kv_local and not got["graphs"]
                      and (mode != "paged" or (want.get("paged_decode")
                                               and got["tables"] == tables)))
                held = (f"streams equal the twin's {same}/{n} (gated)"
                        if name == "f32" else
                        f"streams equal the twin's {same}/{n} (printed, "
                        f"not gated)")
                if name == "f32":
                    ok = ok and same == n
                print(f"multichip (e) engine {mode} {name} "
                      f"MeshSpec(tp={MULTICHIP_TP}) rank {r} "
                      f"{res['runs'][('engine', name)]['coords']}, "
                      f"{got['kv_heads']} of {cfg154.kv_heads} KV heads a "
                      f"rank, {n} s8_r24 requests ({whole} finished "
                      f"whole, every rank's streams the same: {ranks_same})"
                      f": {held}; K1/K2 launches {got['counts']} (expected "
                      f"{want} from its dispatch labels"
                      + (f"; K2 on block tables {got['tables']}, phase 4's "
                         f"{tables}" if mode == "paged" else "")
                      + f"); {got['tokens']} "
                      f"tokens in {got['wall_s']:.2f} s (host-staged gloo "
                      f"on one card beside (a), (b) and (d): not a "
                      f"scaling number); the twin's drain "
                      f"{refs[('engine', name)][mode]['wall_s']:.2f} s "
                      f"{'ok' if ok else 'FAIL'}; {card}", flush=True)
                if not ok:
                    fail(f"multichip (e) engine {mode} {name} disagrees on "
                         f"rank {r}")
                add(got["counts"])

    # (c): the flagship forward, the card against the CPU's plain path
    zero_counts(fa)
    fn, (params, tokens) = ge.entry(device="cuda")
    with torch.no_grad():
        got = fn(params, tokens).float().cpu()
    counts = flash_routes(fa)
    del params
    cfn, (cparams, ctokens) = ge.entry(device="cpu")
    with torch.no_grad():
        want = cfn(cparams, ctokens).float()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    layers = ge.FLAGSHIP["n_layers"]
    ok = (bool(torch.isfinite(got).all()) and err <= TOL[torch.bfloat16]
          * scale and counts["flash_fwd_tc"] == layers
          and counts["flash_fwd_f32"] == 0)
    print(f"multichip (c) graft_entry.entry() forward {tuple(got.shape)} "
          f"bf16 on the card vs the CPU's plain path: max|d| {err:.4g} "
          f"(tol {TOL[torch.bfloat16]} x {scale:.4g}); K1 launches "
          f"{({k: v for k, v in counts.items() if v})} (expected "
          f"{layers} on the tensor cores) {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        fail("multichip (c): entry()'s forward disagrees")
    add({"flash_fwd_tc": counts["flash_fwd_tc"]})
    return total


MEASURE_SIM = dict(seed=7, cycles=20, ab_cycles=70)
#: decode_probe's longer generation (the probe's default 64; the shorter
#: is a quarter of it): its two probes took 37 s of the script's time
#: limit at 64
MEASURE_DECODE_TOKENS = 32
# K7's tuned shapes: (kind, G, M, K, N, dtype, candidates); the 154M
# unembedding at 8 slots and moe_heavy's up-projection (x shared by the
# experts, f32 as the int8 MoE drain runs it; ring 3 there is a plan the
# kernel refuses, recorded as an error run)
MEASURE_TUNE = (
    ("K7a", 1, 8, 1024, 32000, torch.bfloat16,
     [{"k_chunk": c, "ring": r} for c in (1024, 512, 256) for r in (3, 2)]),
    ("K7b", 16, 8, 512, 4096, torch.float32,
     [{"k_chunk": c, "ring": 2} for c in (512, 256, 128)]
     + [{"k_chunk": 512, "ring": 3}]),
)
# weight copies a tuning chain cycles through, so that every call finds
# its weight outside the 50 MB L2, as a decode step does
MEASURE_WEIGHT_COPIES = 4
MEASURE_TUNE_ITERS = 32


def start_sim_probe() -> tuple[subprocess.Popen, Path]:
    """``python -m k8s_dra_driver_tpu_torch.sim.probe`` in a process of
    its own, writing under a fresh temporary directory: the simulator
    runs on the host (no tensor, no device), so it runs beside the
    card's phases and ``phase_measure`` collects it.  The process is
    killed and the directory removed when this script exits, whatever
    the exit."""
    root = Path(__file__).resolve().parent
    tmp = Path(tempfile.mkdtemp(prefix="chip-smoke-sim-"))
    workdir = tmp / "sim"
    args = [sys.executable, "-m", "k8s_dra_driver_tpu_torch.sim.probe",
            "--seed", str(MEASURE_SIM["seed"]),
            "--cycles", str(MEASURE_SIM["cycles"]),
            "--ab-cycles", str(MEASURE_SIM["ab_cycles"]),
            "--workdir", str(workdir)]
    with open(tmp / "sim_probe.err", "w") as err:
        proc = subprocess.Popen(args, cwd=root, stdout=subprocess.PIPE,
                                stderr=err, text=True)

    def stop() -> None:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)

    atexit.register(stop)
    return proc, workdir


#: a phase in a process of its own: runs ``chip_smoke.<argv[1]>()`` and
#: prints its JSON result on the last line
PHASE_CHILD = """
import json
import sys
import chip_smoke
result = getattr(chip_smoke, sys.argv[1])()
print(chip_smoke.PHASE_RESULT + json.dumps(result), flush=True)
"""
PHASE_RESULT = "PHASE RESULT "
#: seconds a phase in a process of its own may take, start to join
PHASE_CHILD_S = 900


class PhaseChild:
    """``chip_smoke.<name>()`` in a process of its own, started here and
    running beside this process's phases; ``join()`` waits for it,
    replays its standard output and error here, fails the run if it
    failed, hung past PHASE_CHILD_S or printed no result, and returns
    its result.  The process runs in a session of its own, and its
    whole group is killed when this script exits, whatever the exit."""

    def __init__(self, name: str):
        root = Path(__file__).resolve().parent
        self.name = name
        self.tmp = Path(tempfile.mkdtemp(prefix="chip-smoke-phase-"))
        self.out, self.err = self.tmp / "out", self.tmp / "err"
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(root)] + [p for p in os.environ.get(
                "PYTHONPATH", "").split(os.pathsep) if p]))
        with open(self.out, "w") as fo, open(self.err, "w") as fe:
            self.proc = subprocess.Popen(
                [sys.executable, "-c", PHASE_CHILD, name], cwd=root,
                env=env, stdout=fo, stderr=fe, start_new_session=True)
        self.t0 = time.perf_counter()
        atexit.register(self.stop)

    def stop(self) -> None:
        if self.proc.poll() is None:
            try:
                os.killpg(self.proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            self.proc.wait()
        shutil.rmtree(self.tmp, ignore_errors=True)

    def join(self):
        try:
            self.proc.wait(max(0.0, PHASE_CHILD_S
                               - (time.perf_counter() - self.t0)))
        except subprocess.TimeoutExpired:
            self.stop()
            fail(f"{self.name}: still running {PHASE_CHILD_S} s after its "
                 f"start")
        took = time.perf_counter() - self.t0
        lines = self.out.read_text().splitlines()
        result = [ln for ln in lines if ln.startswith(PHASE_RESULT)]
        for ln in lines:
            if not ln.startswith(PHASE_RESULT):
                print(ln, flush=True)
        err = self.err.read_text()
        if err:
            print(err, end="" if err.endswith("\n") else "\n",
                  file=sys.stderr, flush=True)
        rc = self.proc.returncode
        self.stop()
        if rc != 0 or not result:
            fail(f"{self.name} (a process of its own) exited rc {rc}"
                 + ("" if result else ", no result"))
        print(f"{self.name}: its own process, {took:.1f} s start to join",
              flush=True)
        return json.loads(result[-1][len(PHASE_RESULT):])


def dims_list(fa, pa) -> list:
    """The wrappers' launches by (entry, dtype, head dim) as a list."""
    return [[*key, n] for key, n in {**fa.dim_launches,
                                     **pa.dim_launches}.items()]


def add_dims(fa, pa, dims: list) -> None:
    """Adds :func:`dims_list`'s counts of another process here."""
    for entry, dtype, d, n in dims:
        table = pa.dim_launches if entry == "paged_decode" else \
            fa.dim_launches
        key = (entry, dtype, d)
        table[key] = table.get(key, 0) + n


def child_setup() -> None:
    """A phase's own process: the card and the settings phase_device
    gives this script."""
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def demo_child() -> dict:
    """The demo phase in a process of its own (see :class:`PhaseChild`):
    its pods are processes and report their K1 launches themselves."""
    child_setup()
    return phase_demo()


def crucible_child() -> dict:
    """The crucible phase in a process of its own: its main-route and
    f32-route launches and its launches by head dim."""
    from k8s_dra_driver_tpu_torch.ops import flash_attention as fa
    from k8s_dra_driver_tpu_torch.ops import paged_attention as pa
    child_setup()
    fa.dim_launches.clear()
    pa.dim_launches.clear()
    with tempfile.TemporaryDirectory() as tmp:
        routes, f32_routes = phase_crucible(fa, pa, Path(tmp))
    return {"routes": routes, "f32_routes": f32_routes,
            "dims": dims_list(fa, pa)}


#: CPU threads a process the multichip phase starts may use: its 14
#: ranks share the host's cores with the mesh phase's 6, and torch's
#: default (a thread a core each) oversubscribes them (PERF.md §6)
MULTICHIP_THREADS = "2"


def multichip_child() -> dict:
    """The multichip phase in a process of its own: its launches by
    route and by head dim.  The processes it starts (the dryrun's ranks,
    (b)'s and (d)'s) take MULTICHIP_THREADS CPU threads each."""
    from k8s_dra_driver_tpu_torch.ops import flash_attention as fa
    from k8s_dra_driver_tpu_torch.ops import paged_attention as pa
    os.environ["OMP_NUM_THREADS"] = MULTICHIP_THREADS
    child_setup()
    fa.dim_launches.clear()
    pa.dim_launches.clear()
    return {"launches": phase_multichip(fa), "dims": dims_list(fa, pa)}


def tune_k7(qm, at, col, tuner, card: str) -> list:
    """``tuner.tune`` over MEASURE_TUNE: each candidate plan timed by the
    differential-median harness (``measure_chain``: a chain of calls
    captured as one CUDA graph, each call through the next of
    MEASURE_WEIGHT_COPIES weights and feeding a scalar of its output
    into the next call's x) and valid only when its output is within
    INT8_TOL of the plain version and the harness found no artifact.
    Returns [(kind, G, M, K, N, dtype, best plan, x, weight, plain
    output, call)]."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20)
    tuned = []
    for kind, g, m, k, n, dtype, cands in MEASURE_TUNE:
        copies = []
        for _ in range(MEASURE_WEIGHT_COPIES):
            w = torch.randn((g, k, n), generator=gen, device=dev) * k ** -0.5
            copies.append(qm.quantize(w, (1,)))
            del w
        x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
        batched = kind == "K7b"

        def call(x2, qt, params, batched=batched, g=g, m=m, k=k):
            if batched:        # btd,edf->btef: x shared, stride 0 over E
                return qm.int8_bmm(x2[None].expand(g, m, k), qt.q,
                                   qt.scale, **params)
            return qm.int8_matmul(x2, qt.q[0], qt.scale[0], **params)

        def plain(x2, qt, batched=batched, g=g, m=m, k=k):
            if batched:
                return qm.int8_bmm_reference(x2[None].expand(g, m, k),
                                             qt.q, qt.scale)
            return qm.int8_matmul_reference(x2, qt.q[0], qt.scale[0])

        want = plain(x, copies[0])
        es = torch.tensor([], dtype=dtype).element_size()
        bound_ms, _ = int8_bound(g, m, k, n, es, m, H100_BF16_FLOPS
                                 if dtype == torch.bfloat16
                                 else H100_F32_FLOPS)
        # the weight's int8 bytes at the harness's generous memory
        # ceiling: a reading below it is an artifact
        floor_s = g * k * n / (col._PEAK_HBM_GBPS_CEILING * 1e9)
        checks = {}

        def measure(params, x=x, copies=copies, want=want, call=call,
                    floor_s=floor_s, checks=checks, dtype=dtype):
            got = call(x, copies[0], params)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            scale = max(1.0, want.float().abs().max().item())
            agrees = err <= INT8_TOL[dtype] * scale
            checks[json.dumps(params, sort_keys=True)] = err

            def body(acc, n_calls):
                for i in range(n_calls):
                    y = call(acc, copies[i % len(copies)], params)
                    # a scalar of the output into the next x keeps the
                    # calls dependent, whatever their shapes
                    acc = acc + (y.float().sum() * 1e-7).to(acc.dtype)
                return acc.float().sum()

            def make(n_calls):
                # the chain is one CUDA graph, as the reference's is one
                # compiled program: a replay times the device, not the
                # host's enqueue of n_calls launches; each call copies
                # its fresh input into the graph's x first
                static_x = x.clone()
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    body(static_x, 1)           # allocations, the plan
                torch.cuda.current_stream().wait_stream(side)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    total = body(static_x, n_calls)

                def chain(arg):
                    static_x.copy_(arg)
                    graph.replay()
                    return total
                return chain

            seconds, valid = col.measure_chain(make, x, MEASURE_TUNE_ITERS,
                                               floor_s)
            return seconds, valid and agrees

        key = at.shape_key(g=g, m=m, k=k, n=n)
        name = "int8_bmm" if batched else "int8_matmul"
        default = qm.int8_plan(g, m, k, n, dtype)
        best = tuner.tune(name, key, dtype, cands, measure)
        entry = tuner.table[at.table_key(name, key, dtype, at.backend_key())]
        for run in entry["runs"]:
            err = checks.get(json.dumps(run["params"], sort_keys=True))
            print(f"measure (a) tune {kind} {key} "
                  f"{str(dtype)[6:]} {run['params']}: "
                  + (f"error {run['error']}" if "error" in run else
                     f"chain_ms={run['ms']:.4f} valid={run['valid']} "
                     f"max|d|={err:.3g} (tol {INT8_TOL[dtype]})")
                  + f" [{card}]", flush=True)
        print(f"measure (a) tune {kind} best {best} (valid "
              f"{entry['valid']}, {entry['ms']:.4f} ms a chained call, the "
              f"fold-back included; int8_plan's "
              f"k_chunk {default.k_chunk} ring {default.ring}; bound "
              f"{bound_ms * 1e3:.2f} us; the kernel table's cold kernel ms "
              f"{'0.0280' if kind == 'K7a' else '0.0438'}) [{card}]",
              flush=True)
        if not entry["valid"]:
            fail(f"{kind}: no tuned candidate was valid")
        tuned.append((kind, g, m, k, n, dtype, best, x, copies[0], want,
                      call))
    return tuned


def measure_counts(fa, qm) -> dict:
    return {"flash_fwd": fa.launches, "flash_fwd_tc": fa.tc_launches,
            "flash_bwd_dq_tc": fa.dq_tc_launches,
            "flash_bwd_dkv_tc": fa.dkv_tc_launches,
            "int8_matmul": qm.launches["int8_matmul"],
            "int8_tc": qm.tc_launches}


def phase_measure(fa, qm, sim: subprocess.Popen, sim_dir: Path,
                  tmp: Path) -> dict:
    """The measurement utilities on the card.  (a) the autotuner:
    ``backend_key`` names the card; the checked-in H100 table holds no
    entries, so every K7 launch of the run took ``int8_plan``'s plan
    (picks by source, none measured); ``Autotuner.tune`` over K7a at
    the 154M unembedding and K7b at moe_heavy's up-projection (each
    candidate held to the plain version); the saved table pointed to
    by ``TPU_AUTOTUNE_TABLE``: the wrapper launches the tuned plan
    within tolerance; the default restored.  (b) the probes of
    ``ops/collectives.py`` at their defaults (the 154M for decode and
    serving), each ``valid``, K1, K3/K4 and K7 launches counted (these
    join the kernels line).  (c) ``utils/profiling.py``: a Chrome trace
    of one 154M generation step (prefill and one decode step) holding
    the ``annotate`` span and K1's kernel, and a device memory
    snapshot; then the fleet simulator's probe, which ran on the HOST
    in its own process beside the serving and training phases
    (``start_sim_probe``; the simulator touches no device): 1000
    replicas, no violation,
    every cycle survived, the minimized repro still starving, and a
    same-seed rerun of its soak here with an equal journal digest.
    Every line carries the card's name and power limit."""
    from k8s_dra_driver_tpu_torch.models import greedy_generate
    from k8s_dra_driver_tpu_torch.ops import autotune as at
    from k8s_dra_driver_tpu_torch.ops import collectives as col
    from k8s_dra_driver_tpu_torch.sim.fleet import SimConfig
    from k8s_dra_driver_tpu_torch.sim.rig import (default_sim_schedule,
                                                  run_sim_soak)
    from k8s_dra_driver_tpu_torch.utils import profiling

    t_phase = time.perf_counter()
    card = card_line()

    # (a) the autotuner and K7's plan
    backend = at.backend_key()
    want_backend = "gpu-" + re.sub(r"[^a-z0-9]+", "-",
                                   torch.cuda.get_device_name(0).lower()
                                   ).strip("-")
    if backend != want_backend:
        fail(f"backend_key {backend!r}, want {want_backend!r}")
    default = at.get_autotuner()
    if default.path != at.DEFAULT_TABLE_PATH or default.table:
        fail(f"the run's table is {default.path} with "
             f"{len(default.table)} entries: want the checked-in H100 "
             f"table, empty")
    print(f"measure (a) backend_key {backend}; table "
          f"{at.DEFAULT_TABLE_PATH.name}: 0 entries; K7 plan picks this "
          f"run by source: {default.picks} [{card}]", flush=True)
    if default.picks["measured"] or not default.picks["default"]:
        fail(f"K7's picks {default.picks}: want every one int8_plan's")
    tuner = at.Autotuner(tmp / "autotune_tuned.json")
    tuned = tune_k7(qm, at, col, tuner, card)
    table = tuner.save(meta={"card": card})
    old_env = os.environ.get(at.TABLE_ENV)
    os.environ[at.TABLE_ENV] = str(table)
    at.reset_autotuner()
    try:
        for kind, g, m, k, n, dtype, best, x, qt, want, call in tuned:
            plan = qm.pick_int8_tiles(g, m, k, n, dtype,
                                      batched=kind == "K7b")
            if (plan.k_chunk, plan.ring) != (best["k_chunk"], best["ring"]):
                fail(f"{kind}: the wrapper's plan {plan} is not the "
                     f"tuned {best}")
            before = dict(qm.launches)
            got = call(x, qt, {})
            torch.cuda.synchronize()
            name = "int8_bmm" if kind == "K7b" else "int8_matmul"
            if qm.launches[name] != before[name] + 1:
                fail(f"{kind}: the tuned call launched no kernel")
            err = (got.float() - want.float()).abs().max().item()
            scale = max(1.0, want.float().abs().max().item())
            print(f"measure (a) {kind} through the tuned table: {plan}, "
                  f"max|d|={err:.3g} (tol {INT8_TOL[dtype]} x {scale:.3g}) "
                  f"[{card}]", flush=True)
            if err > INT8_TOL[dtype] * scale:
                fail(f"{kind} disagrees with its plain version on the "
                     f"tuned plan")
        if at.get_autotuner().picks["measured"] != len(tuned):
            fail(f"tuned picks {at.get_autotuner().picks}")
    finally:
        if old_env is None:
            os.environ.pop(at.TABLE_ENV, None)
        else:
            os.environ[at.TABLE_ENV] = old_env
        at.reset_autotuner()
    if qm.pick_int8_tiles(1, 8, 1024, 32000, torch.bfloat16) != \
            qm.int8_plan(1, 8, 1024, 32000, torch.bfloat16):
        fail("the default table was not restored")
    del tuned
    torch.cuda.empty_cache()

    # (b) the probes; their kernel launches join the main paths'
    start = measure_counts(fa, qm)

    def probe(label, fn, **kw):
        t0 = time.perf_counter()
        before = measure_counts(fa, qm)
        out = fn(**kw)
        after = measure_counts(fa, qm)
        delta = {k2: after[k2] - before[k2] for k2 in after
                 if after[k2] != before[k2]}
        print(f"measure (b) {label} ({time.perf_counter() - t0:.1f} s; "
              f"launches {delta}): {json.dumps(out)} [{card}]", flush=True)
        if not out["valid"]:
            fail(f"{label} is not valid")
        return out, delta

    _, d = probe("attention_probe", col.attention_probe)
    if d.get("flash_fwd_tc", 0) <= 0 or d.get("flash_fwd_tc") != \
            d.get("flash_fwd"):
        fail(f"attention_probe's K1 launches {d}: want all on the tensor "
             f"cores")
    _, d = probe("attention_grad_probe", col.attention_grad_probe)
    if min(d.get(k2, 0) for k2 in ("flash_fwd_tc", "flash_bwd_dq_tc",
                                   "flash_bwd_dkv_tc")) <= 0:
        fail(f"attention_grad_probe's K1/K3/K4 launches {d}")
    probe("matmul_tflops", col.matmul_tflops, dim=4096)
    for int8 in (False, True):
        out, d = probe(f"decode_probe{' int8' if int8 else ''}",
                       col.decode_probe, int8=int8,
                       n_tokens=MEASURE_DECODE_TOKENS)
        if out["implied_gbps"] >= col._DECODE_HBM_GBPS_CEILING:
            fail(f"decode_probe implies {out['implied_gbps']} GB/s")
        if int8 and (d.get("int8_matmul", 0) <= 0
                     or d.get("int8_tc") != d.get("int8_matmul")):
            fail(f"decode_probe int8's K7 launches {d}: want all on the "
                 f"tensor cores")
    for k_steps in (1, FUSED_CHAIN):
        probe(f"serving_probe chain_steps={k_steps}", col.serving_probe,
              slots=8, n_requests=24, prompt_len=96, max_new=48,
              chain_steps=k_steps)
    probe("dispatch_probe", col.dispatch_probe)
    out, _ = probe("allreduce_bandwidth", col.allreduce_bandwidth,
                   devices=["cuda"])
    if out["devices"] != 1:
        fail(f"allreduce_bandwidth ran on {out['devices']} devices")
    end = measure_counts(fa, qm)
    counts = {k2: end[k2] - start[k2] for k2 in end}
    print(f"measure (b) the probes' kernel launches: {counts} [{card}]",
          flush=True)

    # (c) profiling: one 154M generation step, traced
    cfg, params = serving_model()
    prompt = torch.randint(0, cfg.vocab, (8, 96),
                           generator=torch.Generator().manual_seed(3)
                           ).to("cuda")
    with torch.no_grad():
        greedy_generate(params, prompt, cfg, 2)          # warm
        torch.cuda.synchronize()
        with profiling.trace(tmp / "trace"):
            with profiling.annotate("measure-generation-step"):
                greedy_generate(params, prompt, cfg, 2)
                torch.cuda.synchronize()
    traces = sorted((tmp / "trace").glob("*.json"))
    if len(traces) != 1:
        fail(f"trace wrote {traces}")
    names = {e.get("name", "") for e in json.loads(
        traces[0].read_text())["traceEvents"]}
    k1_names = sorted(n for n in names if "flash_fwd_sm90_kernel" in n)
    if "measure-generation-step" not in names or not k1_names:
        fail(f"the trace lacks the span or K1 ({len(names)} names)")
    snap = profiling.device_memory_profile(tmp / "memory.pickle")
    print(f"measure (c) trace {traces[0].name}: "
          f"{traces[0].stat().st_size} bytes, {len(names)} event names, "
          f"the annotate span and K1 as {k1_names[0][:60]!r}; device "
          f"memory snapshot {snap.stat().st_size} bytes [{card}]",
          flush=True)
    if snap.stat().st_size <= 0:
        fail("empty device memory snapshot")
    del params
    torch.cuda.empty_cache()

    # (c) the fleet simulator (host only)
    t0 = time.perf_counter()
    out, _ = sim.communicate(timeout=600)
    waited = time.perf_counter() - t0
    if sim.returncode:
        fail(f"the simulator probe exited {sim.returncode}: "
             f"{(sim_dir.parent / 'sim_probe.err').read_text()[-2000:]}")
    res = json.loads(out.strip().splitlines()[-1])
    print(f"measure (c) fleet_sim_probe (host, its own process; this "
          f"phase waited {waited:.1f} s for it): {json.dumps(res)} "
          f"[{card}]", flush=True)
    if (res["sim_replicas"], res["sim_invariant_violations"],
            res["sim_survived_cycles"], res["sim_repro_starved"]) != (
                1000, 0, MEASURE_SIM["cycles"], True):
        fail("fleet_sim_probe: want 1000 replicas, 0 violations, every "
             "cycle survived and the repro starving")
    first = json.loads((sim_dir / "scale" / "sim_soak.json").read_text())
    t0 = time.perf_counter()
    _, fleet = run_sim_soak(
        default_sim_schedule(MEASURE_SIM["seed"],
                             cycles=MEASURE_SIM["cycles"]),
        tmp / "sim_rerun", config=SimConfig(seed=MEASURE_SIM["seed"]))
    digest = fleet.journal_digest()
    print(f"measure (c) same-seed rerun of the 1000-replica soak "
          f"({time.perf_counter() - t0:.1f} s, host): digest {digest[:16]} "
          f"{'==' if digest == first['journal_digest'] else '!='} the "
          f"probe's {first['journal_digest'][:16]}, "
          f"{fleet.heap.processed} events [{card}]", flush=True)
    if digest != first["journal_digest"]:
        fail("the same-seed rerun's journal digest differs")
    print(f"measure: phase wall {time.perf_counter() - t_phase:.1f} s "
          f"[{card}]", flush=True)
    return counts


#: the kernels-line names of the kernels the small head dims reach, and
#: their SMALL_D_ROWS keys
SMALL_D_KERNELS = {"flash_fwd": "K1", "flash_fwd_block": None,
                   "paged_decode": "K2", "flash_bwd_dq": "K3",
                   "flash_bwd_dkv": "K4"}
#: the small dims each kernel must have run at on the main paths: every
#: prompt fill of the probes (K1); the paged-KV probe (16) and the
#: crucible's paged replica (8) (K2); the gangs
#: of the recovery, fleet and multitenant probes and of the crucible
#: (K3, K4).  No probe runs K1's block entry at a small dim: phase 3b
#: holds it there
SMALL_D_REQUIRED = {"flash_fwd": (8, 16, 32), "paged_decode": (8, 16),
                    "flash_bwd_dq": (8,), "flash_bwd_dkv": (8,)}


def small_d_launches(fa, pa) -> dict:
    """The main paths' launches at the small head dims by kernel, head
    dim and dtype (the wrappers' ``dim_launches`` since they were
    cleared after the kernel phases); fails unless each kernel ran at
    every dim SMALL_D_REQUIRED names."""
    out = {name: {str(d): {} for d in SMALL_DIMS} for name in SMALL_D_KERNELS}
    for (entry, dtype, d), n in {**fa.dim_launches,
                                 **pa.dim_launches}.items():
        if d in SMALL_DIMS:
            out[entry][str(d)][dtype] = n
    for name, dims in SMALL_D_REQUIRED.items():
        missing = [d for d in dims if not sum(out[name][str(d)].values())]
        if missing:
            fail(f"{name} never ran at head dims {missing} on the main "
                 f"paths: {out[name]}")
    return out


def main() -> None:
    clock = ScriptClock()
    kind = phase_device()
    from k8s_dra_driver_tpu_torch.models import quant as qm
    from k8s_dra_driver_tpu_torch.models.serving import ServingEngine
    from k8s_dra_driver_tpu_torch.ops import _build
    from k8s_dra_driver_tpu_torch.ops import flash_attention as fa
    from k8s_dra_driver_tpu_torch.ops import gmm as gm
    from k8s_dra_driver_tpu_torch.ops import paged_attention as pa

    clock.mark("device and imports")
    phase_build(_build)
    clock.mark("build")
    phase_driver()
    clock.mark("driver")
    phase_plugin()
    clock.mark("plugin")
    coordination = phase_coordination()
    clock.mark("coordination")
    k1, k1_probes = phase_flash(fa)
    k1b, k1b_probes = phase_flash_block(fa)
    k2, k2_probes = phase_paged(pa)
    k3, k4, bwd_probes = phase_flash_bwd(fa)
    k5, k6, gmm_probes = phase_gmm(gm)
    k7a, k7b, int8_probes = phase_int8(qm)
    clock.mark("kernels")
    # the launches by head dim count the main paths from here on (the
    # reference-width probes run the small dims)
    fa.dim_launches.clear()
    pa.dim_launches.clear()
    # the fleet simulator's probe runs on the host beside the later
    # phases (after the kernel timings, which it must not disturb)
    sim, sim_dir = start_sim_probe()
    # the demo's pods and the crucible run in processes of their own
    # beside the serving phases (their gates hold counts and outcomes,
    # not times; the serving phases' host rates are read beside them)
    demo_proc = PhaseChild("demo_child")
    crucible_proc = PhaseChild("crucible_child")

    cfg, params = serving_model()
    reqs = s8_r24(cfg.vocab)
    # the coordination phase's K1 children and leased replica (the
    # demo's serve pod joins them below)
    launches = dict(coordination["launches"])

    done_c, counts, _, _ = drain(ServingEngine, params, cfg, reqs, fa, pa,
                              "contiguous", top_k=50)
    if counts["flash_fwd"] <= 0:
        fail("contiguous drain launched no flash kernel")
    worst = teacher_forced(params, cfg, done_c, reqs)
    print(f"teacher-forced (contiguous): worst gap {worst:.4f} <= "
          f"{TF_MARGIN}", flush=True)
    for name in launches:
        launches[name] += counts[name]

    done_p, counts, stats_p, _ = drain(ServingEngine, params, cfg, reqs, fa,
                                       pa, "paged", top_k=50,
                                       kv_layout="paged")
    if counts["flash_fwd"] <= 0 or counts["paged_decode"] <= 0:
        fail(f"paged drain kernel launches {counts}: both must be > 0")
    worst = teacher_forced(params, cfg, done_p, reqs)
    print(f"teacher-forced (paged): worst gap {worst:.4f} <= "
          f"{TF_MARGIN}", flush=True)
    for name in launches:
        launches[name] += counts[name]
    same = sum(np.array_equal(a.tokens, b.tokens) for a, b in zip(
        sorted(done_c, key=lambda f: f.uid),
        sorted(done_p, key=lambda f: f.uid)))
    print(f"paged vs contiguous: {same}/24 streams identical (bf16 "
          f"kernel and plain reads may part after near ties)", flush=True)

    done_x, counts, stats, _ = drain(
        ServingEngine, params, cfg, reqs, fa, pa, "paged-preempt",
        top_k=50, kv_layout="paged", max_seq=256, kv_blocks=41)
    if stats["kv_preemptions_total"] < 1:
        fail("the shrunken pool forced no preemption")
    if counts["paged_decode"] <= 0:
        fail("preemption drain launched no paged kernel")
    worst = teacher_forced(params, cfg, done_x, reqs)
    print(f"teacher-forced (paged, {stats['kv_preemptions_total']} "
          f"preemptions): worst gap {worst:.4f} <= {TF_MARGIN}",
          flush=True)
    for name in launches:
        launches[name] += counts[name]
    clock.mark("drains")
    refs = {"bf16 paged": (done_p, stats_p),
            "bf16 paged-preempt": (done_x, stats)}
    del done_c
    counts = phase_int8_serving(params, cfg, reqs, fa, pa)
    for name in ("flash_fwd", "flash_fwd_tc", "paged_decode",
                 "int8_matmul", "int8_bmm", "int8_tc"):
        launches[name] = launches.get(name, 0) + counts[name]
    counts, fused_refs = phase_fused_serving(params, cfg, reqs, fa, pa)
    for name in ("flash_fwd", "flash_fwd_tc", "paged_decode",
                 "int8_matmul", "int8_bmm", "int8_tc"):
        launches[name] = launches.get(name, 0) + counts[name]
    refs.update(fused_refs)
    clock.mark("int8 and fused serving")
    counts, spec_refs = phase_spec_serving(params, cfg, reqs, fa, pa, refs)
    for name in ("flash_fwd", "flash_fwd_tc", "paged_decode",
                 "int8_matmul", "int8_bmm", "int8_tc"):
        launches[name] = launches.get(name, 0) + counts[name]
    refs.update(spec_refs)
    clock.mark("spec serving")
    counts = phase_lora_serving(params, cfg, reqs, fa, pa, refs)
    for name in ("flash_fwd", "flash_fwd_tc", "paged_decode",
                 "int8_matmul", "int8_bmm", "int8_tc"):
        launches[name] = launches.get(name, 0) + counts[name]
    clock.mark("lora serving")
    for name, n in phase_disagg_tiers(params, cfg, reqs, fa, pa,
                                      refs).items():
        launches[name] += n
    del refs, fused_refs, spec_refs, done_p, done_x
    clock.mark("disagg and tiers")
    demo = demo_proc.join()
    for name, n in demo["launches"].items():
        launches[name] += n
    cru = crucible_proc.join()
    add_dims(fa, pa, cru["dims"])
    clock.mark("the demo's and the crucible's processes")
    for name, n in phase_fleet(params, cfg, reqs, fa, pa).items():
        launches[name] += n
    clock.mark("fleet")
    # the pumps' K1 (f32) joins the flash_fwd entry's f32 route
    for name, n in phase_procfleet(params, cfg, reqs, fa, pa).items():
        launches[name] += n
    del params
    clock.mark("procfleet")
    # observability and the fleet control loop: their own 154M weights
    for phase in (phase_observability, phase_fleet_control):
        for name, n in phase(cfg, reqs, fa, pa).items():
            launches[name] += n
        clock.mark(phase.__name__.removeprefix("phase_"))

    f32_routes = phase_train_small(fa)
    record = {}
    with tempfile.TemporaryDirectory() as tmp:
        counts = phase_train(fa, Path(tmp), record)
    for name, n in counts.items():
        launches[name] = launches.get(name, 0) + n
    clock.mark("train")
    with tempfile.TemporaryDirectory() as tmp:
        gang_bf16, gang_f32 = phase_gang_recovery(fa, pa, Path(tmp))
    clock.mark("gang recovery")
    for name, n in gang_bf16.items():
        launches[name] = launches.get(name, 0) + n
    for name in ("flash_fwd_f32", "flash_bwd_dq_f32", "flash_bwd_dkv_f32"):
        f32_routes[name] += gang_f32[name]
    # the crucible (its own process, beside the serving phases): its K1
    # launches join flash_fwd (both routes: the f32 ones count through
    # flash_fwd - flash_fwd_tc), K2 paged_decode, K3/K4 their
    # tensor-core and f32 routes
    for name, n in cru["routes"].items():
        launches[name] = launches.get(name, 0) + n
    for name, n in cru["f32_routes"].items():
        f32_routes[name] += n
    # the sp path's kernels (summed over ranks): K1's block entry, and
    # K3/K4 beside the single-device steps'
    sp = phase_sp_train(fa, record)
    launches["flash_fwd_block_tc"] = sp["block_tc"]
    f32_routes["flash_fwd_block_f32"] = sp["block_f32"]
    launches["flash_bwd_dq_tc"] += sp["dq_tc"]
    launches["flash_bwd_dkv_tc"] += sp["dkv_tc"]
    clock.mark("sp train")

    for name, n in phase_moe_train_small(fa, gm).items():
        f32_routes[name] = f32_routes.get(name, 0) + n
    moe_record = {}
    with tempfile.TemporaryDirectory() as tmp:
        counts = phase_moe_train(fa, gm, Path(tmp), moe_record)
    counts_drain = phase_moe_serving(fa, pa, gm)
    counts_int8 = phase_int8_moe_serving(fa, pa)
    for part in (counts, counts_drain, counts_int8):
        for name, n in part.items():
            launches[name] = launches.get(name, 0) + n
    clock.mark("moe train and serving")
    # the multichip certification runs in a process of its own beside
    # the mesh phase: both gate values and counts, not walls
    multichip_proc = PhaseChild("multichip_child")
    # tp, ep and pp (summed over ranks): the tensor-core launches join
    # the main path's, the f32 small steps' their routes
    for name, n in phase_mesh_train(fa, gm, record, moe_record).items():
        if name.endswith("_f32"):
            f32_routes[name] = f32_routes.get(name, 0) + n
        else:
            launches[name] = launches.get(name, 0) + n
            if name == "flash_fwd_tc":
                launches["flash_fwd"] += n
    clock.mark("mesh train")
    # the multichip certification (summed over ranks): the dryrun's f32
    # launches join their routes, the 154M tp prefills' and the flagship
    # forward's K1 the main path's (both routes), as do the tp ranks' K2
    # (the paged variant) and K7 (the int8-weight variant: int8_tc of
    # them on the tensor cores) and moe_heavy's ep x tp prefills' K1
    multichip = multichip_proc.join()
    add_dims(fa, pa, multichip["dims"])
    for name, n in multichip["launches"].items():
        if name.endswith("_f32"):
            f32_routes[name] = f32_routes.get(name, 0) + n
        else:
            launches[name] = launches.get(name, 0) + n
            if name == "flash_fwd_tc":
                launches["flash_fwd"] += n
    clock.mark("multichip (its own process, beside the mesh phase)")
    # the measurement utilities: the probes' K1, K3/K4 and K7 launches
    with tempfile.TemporaryDirectory() as tmp:
        for name, n in phase_measure(fa, qm, sim, sim_dir,
                                     Path(tmp)).items():
            launches[name] = launches.get(name, 0) + n
    clock.mark("measure")
    print(f"kernel launches on the main paths (the coordination phase's "
          f"gated and time-sliced K1 children and leased replica + the "
          f"demo's serve pod + "
          f"{30 + DISAGG_DRAINS} "
          f"drains + {FLEET_DRAINS} fleet drains + the process fleet's "
          f"oracle, surviving pumps and codec block + the observability "
          f"drain and paged-KV probes + the control loops and their "
          f"oracle + the gang recovery arcs + the crucible's soaks + "
          f"{TRAIN_STEPS} train "
          f"steps of each of the 154M and moe_heavy + {SP_STEPS} sp steps of the 154M on {SP_WORLD} ranks + the mesh phase's tp, ep and pp steps on {SP_WORLD} ranks + the multichip phase's dryrun on {MULTICHIP_WORLD} ranks, 154M tp={MULTICHIP_TP} runs ({', '.join(MULTICHIP_VARIANTS)}) and engine drains ({', '.join(MULTICHIP_ENGINE_MODES)}), moe_heavy ep x tp run and flagship forward + the measurement probes): "
          f"{launches}", flush=True)

    # device time at the main-path shape and at a long context,
    # profiled last: profiling before the drains and the steps would
    # tax their every launch
    for name, row, by_shape in (("K1", k1, k1_probes),
                                ("K1 block", k1b, k1b_probes),
                                ("K2", k2, k2_probes),
                                ("K3", k3, bwd_probes["K3"]),
                                ("K4", k4, bwd_probes["K4"]),
                                ("K5", k5, gmm_probes["K5"]),
                                ("K6", k6, gmm_probes["K6"]),
                                ("K7a", k7a, int8_probes["K7a"]),
                                ("K7b", k7b, int8_probes["K7b"])):
        # K7 as a decode step finds its weights: not in L2
        timer = cold_device_ms if name.startswith("K7") else device_ms
        for shape, probes in by_shape.items():
            times = {what: timer(fn) for what, fn in probes.items()}
            if shape.endswith("(main path)"):
                row["device_ms"] = times["kernel"]
                # no reading of the kernel or its library call may beat
                # the bound
                for key, what in (("ms", "kernel"), ("device_ms", "kernel"),
                                  ("library_ms", "library")):
                    got = row.get(key)
                    if got is not None and got < row["bound_ms"]:
                        row.setdefault("impossible", {})[key] = got
                        row[key] = trusted(f"{name} {shape}", key, got,
                                           row["bound_ms"],
                                           probes.get(what))
            print(f"{name} device_ms at {shape} (kernels only, host gaps "
                  f"excluded): "
                  + " ".join(f"{w}={fmt(t)}" for w, t in times.items()),
                  flush=True)
            if name == "K6" and shape.endswith("(main path)"):
                # K6's library call once read half its bound: its
                # yardstick is also timed cold, beside the kernel's
                row["cold_device_ms"] = {
                    what: cold_device_ms(probes[what])
                    for what in ("kernel", "library") if what in probes}
                print(f"K6 cold device_ms (L2 flushed) at {shape}: "
                      + " ".join(f"{w}={fmt(t)}" for w, t in
                                 row["cold_device_ms"].items()),
                      flush=True)

    clock.mark("device times")
    small = small_d_launches(fa, pa)
    print(f"small head dims on the main paths (the reference-width "
          f"probes; entry -> head dim -> dtype -> launches): "
          f"{json.dumps(small)}", flush=True)

    # K1 and K5: the tensor-core route the bf16 main paths take; the
    # f32 route's launches (K1: the f32 MoE drains and card steps; K5:
    # the f32 MoE card step) apart
    kernels = [
        dict(name="flash_fwd", route="cuda",
             source="k8s_dra_driver_tpu_torch/csrc/flash_fwd_sm90.cu",
             replaces="k8s_dra_driver_tpu/ops/flash_attention.py:122",
             launches=launches["flash_fwd_tc"],
             f32_route_source="k8s_dra_driver_tpu_torch/csrc/flash_fwd.cu",
             f32_route_launches=(launches["flash_fwd"]
                                 - launches["flash_fwd_tc"]
                                 + f32_routes["flash_fwd_f32"]), **k1),
        # K1's block entry, the ring hops of the sp steps (bf16 on the
        # tensor cores); the f32 small ring step's launches apart
        dict(name="flash_fwd_block", route="cuda",
             source="k8s_dra_driver_tpu_torch/csrc/flash_fwd_sm90.cu",
             replaces="k8s_dra_driver_tpu/ops/flash_attention.py:397",
             launches=launches["flash_fwd_block_tc"],
             f32_route_source="k8s_dra_driver_tpu_torch/csrc/flash_fwd.cu",
             f32_route_launches=f32_routes["flash_fwd_block_f32"], **k1b),
        dict(name="paged_decode", route="cuda",
             source="k8s_dra_driver_tpu_torch/csrc/paged_decode.cu",
             replaces="k8s_dra_driver_tpu/ops/paged_attention.py:125",
             launches=launches["paged_decode"], **k2),
        # the tensor-core route the bf16 main paths take; the f32
        # route's launches (the f32 card steps of phases 9 and 11) apart
        dict(name="flash_bwd_dq", route="cuda",
             source="k8s_dra_driver_tpu_torch/csrc/flash_bwd_sm90.cu",
             replaces="k8s_dra_driver_tpu/ops/flash_attention.py:727",
             launches=launches["flash_bwd_dq_tc"],
             f32_route_source="k8s_dra_driver_tpu_torch/csrc/flash_bwd.cu",
             f32_route_launches=f32_routes["flash_bwd_dq_f32"], **k3),
        dict(name="flash_bwd_dkv", route="cuda",
             source="k8s_dra_driver_tpu_torch/csrc/flash_bwd_sm90.cu",
             replaces="k8s_dra_driver_tpu/ops/flash_attention.py:790",
             launches=launches["flash_bwd_dkv_tc"],
             f32_route_source="k8s_dra_driver_tpu_torch/csrc/flash_bwd.cu",
             f32_route_launches=f32_routes["flash_bwd_dkv_f32"], **k4),
        dict(name="gmm", route="cuda",
             source="k8s_dra_driver_tpu_torch/csrc/gmm_sm90.cu",
             replaces="k8s_dra_driver_tpu/ops/gmm.py:79",
             launches=launches["gmm_tc"],
             f32_route_source="k8s_dra_driver_tpu_torch/csrc/gmm.cu",
             f32_route_launches=f32_routes["gmm_f32"], **k5),
        dict(name="gmm_dw", route="cuda",
             source="k8s_dra_driver_tpu_torch/csrc/gmm_dw_sm90.cu",
             replaces="k8s_dra_driver_tpu/ops/gmm.py:126",
             launches=launches["gmm_dw_tc"],
             f32_route_source="k8s_dra_driver_tpu_torch/csrc/gmm.cu",
             f32_route_launches=f32_routes["gmm_dw_f32"], **k6),
        # one source, two routes by x's dtype: the 154M int8 drains'
        # bf16 K7a on the tensor cores, the f32 int8 MoE drain's K7a and
        # K7b on the CUDA cores
        dict(name="int8_matmul", route="cuda",
             source="k8s_dra_driver_tpu_torch/csrc/int8_matmul_sm90.cu",
             replaces="k8s_dra_driver_tpu/models/quant.py:199",
             launches=launches["int8_matmul"],
             launches_by_route={
                 "tensor_cores": launches["int8_tc"],
                 "cuda_cores": (launches["int8_matmul"]
                                - launches["int8_tc"])},
             **k7a),
        dict(name="int8_bmm", route="cuda",
             source="k8s_dra_driver_tpu_torch/csrc/int8_matmul_sm90.cu",
             replaces="k8s_dra_driver_tpu/models/quant.py:255",
             launches=launches["int8_bmm"],
             launches_by_route={"tensor_cores": 0,
                                "cuda_cores": launches["int8_bmm"]},
             **k7b),
    ]
    for k in kernels:
        if k["name"] in small:
            k["small_d_launches"] = small[k["name"]]
        row = SMALL_D_ROWS.get(SMALL_D_KERNELS.get(k["name"]))
        if row is not None:
            k["small_d"] = row
        rows = TP_RANK_ROWS.get({"flash_fwd": "K1", "paged_decode": "K2",
                                 "int8_matmul": "K7a"}.get(k["name"]))
        if rows:
            k["tp_rank"] = rows
    if min(k["launches"] for k in kernels) <= 0:
        fail(f"a kernel was never launched on the main paths: {launches}")
    print(f"script clock (host seconds): {clock.summary()}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
