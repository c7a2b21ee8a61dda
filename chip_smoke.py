#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one GPU
and check them.

    python3 chip_smoke.py [--seed 0]
    python3 chip_smoke.py --phases histogram,fused   # kernel phases alone
    python3 chip_smoke.py --phases threefry,train_sampled   # the samplers
    python3 chip_smoke.py --phases train_categorical   # categorical, EFB
    python3 chip_smoke.py --phases train_api   # cv, init_model, sklearn
    python3 chip_smoke.py --phases train_breadth   # constraints, modes
    python3 chip_smoke.py --phases train_objectives   # L1 ... xentropy
    python3 chip_smoke.py --phases train_rank   # lambdarank, xendcg
    python3 chip_smoke.py --phases train_sparse   # CSR, binary cache
    python3 chip_smoke.py --phases train_files   # files, external memory
    python3 chip_smoke.py --phases train_stream   # streamed, the ledger
    python3 chip_smoke.py --phases train_dist,serve_sharded   # 2 ranks
    python3 chip_smoke.py --phases golden,main       # serving alone
    python3 chip_smoke.py --phases predict_api   # device_predict, options
    python3 chip_smoke.py --phases serve_plane   # rungs, registry, HTTP
    python3 chip_smoke.py --phases compare --baseline DIR   # K1-K6, sum
    python3 chip_smoke.py --phases compare_serving --baseline DIR

Phases, each printing one JSON line:

  env     torch and CUDA versions, the card (nvidia-smi), the build of
          every kernel (`compiler/_build.build_all`, one nvcc per source,
          all started together) with its time and the compiler's
          register report for each source; the device time of an empty
          kernel's launch (the floor of a few-microsecond kernel).
  golden  the five model files under tests/data/, and two wide synthetic
          models (64 and 300 features; for these also a 4096-row batch,
          where the fused kernel's row blocks are largest and opt in to
          more shared memory), through a GPU ServingRuntime with small
          tiles, on the runtime's probe rows plus adversarial rows (NaN,
          +-inf, +-0, subnormals, values at thresholds, categorical edge
          values, f64 values that saturate in the f32 cast): the fused
          serving kernel (`csrc/serve.cu`) at its default launch plan
          and at every (cluster, staged records, rows in shared memory)
          variant, bitwise its plain version (the same records) and the
          standalone kernels' plain versions (the JAX layout); the
          standalone traverse (rows in shared and in device memory) and
          sum, bitwise their plain versions; raw and converted scores
          against the port's CPU path, bitwise.  Every launch branch
          must run.
  main    the full-width model: 500 trees x 255 leaves x 28 features,
          binary, built from --seed by `synthetic_forest_text` (the
          Higgs shape of upstream LightGBM's docs/Experiments.rst).
          ServingRuntime on the GPU answers 1, 37, 256, 1000, 4096 and
          10000 rows; each answer equals the plain versions on the card
          (the fused one and the standalone ones) and the f64 host
          walk, bitwise.  Kernel launch counts are read around this
          phase alone: the fused kernel and the link run, the
          standalone kernels do not; then per request.  Then
          latencies, and at 1, 256 and 4096 rows the fused kernel, the
          standalone traverse and sum and the unfused program (both
          traverses and the sum), warm and with L2 flushed, beside their
          bounds, and a sweep of the fused kernel's launch plans
          (FUSED_SWEEP, each bitwise first); the plain versions at 4096;
          one 4096-row request split into its stages.
  predict_api `Booster.predict`'s options on the main phase's model:
          `device_predict` (the JAX package's f32 batch program: within
          the plan one launch of the fused serving kernel's f32 instance,
          `csrc/serve.cu lgbt_serve_f32`, a chunk of 65,536 rows, the walk
          over the plan's records and the f32 boosting-order sum, then
          the link a converted chunk) at 1, 256, 4096, 10,000 and 100,000
          rows (two chunks), raw and converted, bitwise the same program
          with every plain version on the card and, up to 10,000 rows,
          the port's CPU result; the rows whose leaves differ from the
          f64 host walk's (0 on this model's f32-exact rows and
          thresholds) and the f32 sums' largest difference from the
          walk; the five golden models and a random-forest text (the
          binary golden text with `average_output`) the same way on
          adversarial rows; launches a request (the f32 fused kernel once
          a chunk; the f64 fused kernel, the standalone traverse and the
          standalone sums 0; the link once a converted chunk) and for the
          phase.  Then on every model at 1, 256, 4096 and 65,536 rows,
          raw and converted, the fused route bitwise its plain versions
          and the unfused program (each bucket's standalone traverse,
          then the f32 sum of their slots); the stacked route (the main
          model with a feature renamed past the plan's 12-bit field: one
          stacked traversal and one f32 sum a chunk) bitwise the fused
          route; the fused f32 launch at those sizes warm and L2-flushed
          in turns with the unfused program, beside its bound (the
          32-byte sectors of the records and leaf values the walks
          read), and a sweep of its launch plans (FUSED_F32_SWEEP) at
          4096 and 65,536 rows, each bitwise the default plan, timed at
          65,536; the standalone f32 sum
          (the stacked route's) at 4096 rows timed warm and L2-flushed
          beside its bound, its plain version and the f64 standalone
          sum; the host seconds of `pred_leaf`, prediction early stop
          and `pred_contrib` (TreeSHAP) on 20 rows of the binary golden
          model.
  serve_plane the serving plane on the main phase's model.  Between the
          counter reads: a ServingRuntime pinned to each rung by its
          options (compiled, device_sum, slot_path, bounded at 8 and 16
          bits) answering 1, 256 and 4096 rows raw and converted, each
          exact rung bitwise the f64 host walk, the bounded one within
          its published bound; a narrow request (28 columns of a model
          that needs 41: the main model plus one guard tree behind a
          root no row passes) walked on the host.  Launches a request by
          rung and each rung's p50.  The stacked-plane traversal
          (`csrc/stacked.cu`) bitwise its plain version at 1, 256 and
          4096 rows on the main model, the golden models with
          adversarial rows, a categorical model with bitsets of 3, 7
          and 313 words, and doctored planes (feature ids past F,
          negative and past a record's field, node ids past NI, cycles)
          at 1, 3, 256 and 4096 rows, timed warm and L2-flushed beside
          its bound, and a sweep of its launch plans; the bounded sum
          (`csrc/bounded.cu`) bitwise its plain version (and the CPU's)
          on the K6 slots of the bounded rung at 8 and 16 bits and 1, 3,
          256 and 4096 rows, raw and converted, its error against the
          f64 sum beside the bound, its planes' bytes under a third of
          the compiled planes', timed; on synthetic forests whose
          classes lack some tiles, with 45 tiles, with its groups in
          several chunks and with 100 classes; a sweep of its launch
          plans.  The (q) model (feature 27 renamed 4096) on
          the device-sum rung and `device_predict`'s stacked route, both
          bitwise.  ModelRegistry + MicroBatcher + make_server on
          127.0.0.1: 8 client threads of 200 requests of 1-256 rows,
          every response bitwise the runtime's direct answer, p50/p99
          over HTTP and direct, rows per batch, /healthz and /metrics.
          Faults after the load: an injected error answers 503, opens
          only the compiled breaker and is counted; after disarm and the
          0.2 s backoff the re-probe closes it and the bytes are those
          before; a hang is bounded by a 500 ms watchdog.
  objective the objectives' links (`ops/xla_math.py`, XLA's CPU exp,
          sigmoid and softmax): the link kernel (`csrc/links.cu`) bitwise
          its plain version (torch ops) on the card and on the CPU, for
          exp on 2^24 f32 bit patterns and sigmoid on 2M scores, and on
          the card over all 2^32 f32 inputs, exp and sigmoid (0 may
          differ); on 2M rows, binary (with and without weights) and
          multiclass `grad_hess` on the card bitwise the same code on the
          CPU.  Then the sigmoid kernel, its plain version and
          `torch.sigmoid` timed, L2 warm and flushed, and binary
          `grad_hess`.
  histogram the K1 kernel (`csrc/histogram.cu`) against its plain
          version on the card, on the train phase's data (2M rows x 28
          features, u8): every row in one slot, a leaf of 1% of the rows,
          14 slots of which two match no row, and a u16 case (max_bin
          1023, 100k rows).  Counts exact, g and h within
          1e-4 * sum|x| + 1e-6 per cell, two launches bitwise equal;
          at the 1% leaf and u16, bitwise equal to
          `histogram_multi_ordered` (the kernel's order of adds, on the
          CPU).  Then K1 timed at every case (`ms` at the host's pace,
          `device_ms` with its launches queued behind a spin kernel)
          beside the bytes its inputs need, and its plain version and
          `index_add_` at the root.
  train   the training path at full width: `lightgbm_tpu_torch.train` on
          a Higgs-shaped binary problem (2M training rows, 200k held
          out, 28 features; binary, 255 leaves, max_bin 255, learning
          rate 0.1, 10 rounds).  Two kernel-trained runs must give
          byte-identical model text; the held-out AUC must be within
          1e-3 of a model trained on the card with hist_impl=segment_sum;
          the kernel-trained model served by ServingRuntime on the card
          must answer bitwise equal to the host walk at f32-rounded
          thresholds (the serving path's routing; the rows where the
          walk at the model's f64 thresholds differs are counted).
          Kernel launch counts are read around this phase alone.  Then round times,
          K1's share of them, host binning seconds and host syncs.
  fused   the fused histogram+split kernel K2 and the scan kernel K3
          (`csrc/fused_split.cu`) on the train phase's bins: S = 1 at the
          root, S = 1 on one leaf of a depth-5 partition (about 1/32 of
          the rows, a strict-tail leaf's size at 31 leaves), S = 8 and
          S = 14 over a real partition of the rows (one slot matching no
          row), S = 42 over a depth-6 partition (K2 in three launches),
          u16 bins at max_bin 1023.  K2's
          histogram within 1e-4*sum|x|+1e-6 of its plain version run on
          the card (counts exact) and bitwise K1's; K2's candidates
          bitwise the plain scan run on the card over that histogram;
          K3's bitwise K2's; `decide_from_candidates` field for field
          `find_best_split`; two launches bitwise equal.  Then K2 (at the
          host's pace and as device time), K3 (device time, its launches
          queued behind a spin kernel), their plain versions and K1
          timed, and the bounds of the bytes the inputs need.
  train_wave  the bench's wave configuration (tree_grow_policy=wave,
          width 8, gain ratio 0, strict tail 16, num_leaves 31) on the
          train phase's data, 10 rounds: two fused runs byte-identical,
          an unfused run (K1 and the torch split search) byte-identical,
          held-out AUC within 1e-3 of hist_impl=segment_sum, and per
          round K2 launches = 1 + waves that built histograms, K3
          launches = those waves, host syncs = 1 + those waves.  Then a
          255-leaf, 14-wide run (K2 at its full 14-slot chunk), fused
          against unfused.  Round times, K2's and K3's share, waves and
          syncs per tree, one profiled round.
  histogram_q the quantized histogram kernel K4 (`csrc/histogram_q.cu`)
          against its plain version on the card, bitwise, over the int8
          lattice of a binary payload quantized to 15 levels with
          stochastic rounding: S = 1 at the 2M x 28 root, on a leaf of
          1% of the rows and on a depth-5 leaf, S = 8 over a depth-3
          partition (one slot matching no row), S = 42 over a depth-6
          partition, u16 bins at max_bin 1023; two launches bitwise
          equal.  Then K4 (device time, its launches queued behind a
          spin kernel) at every case, its plain version and
          `index_add_` of the same integer histogram timed, the bounds
          of the bytes the inputs need.
  fused_q the fused quantized kernel K5 (`csrc/fused_split.cu`) at the
          same shapes: its histogram bitwise K4's and its plain
          version's, its candidates bitwise the plain scan's and K3's;
          the quantizer's stochastic rounding (threefry) on the card
          bitwise the CPU's.  Then K5, its plain version, K4 and K3
          over K5's histogram timed.
  train_quant quantized training (`benchmarks/configs_r4.py` QUANT) on the
          train phase's data: the main run `wave_w8_tail_auto+quant` (31
          leaves, 10 rounds) timed, with per round K5 launches = 1 +
          waves that built histograms and K3 launches = those waves; a
          second run, an unfused run (K4 and the torch split search) and
          `hist_impl=packed` byte-identical to it; the held-out AUC beside
          the f32 wave model's.  Then `strict+quant` at 255 leaves (K4 at
          S = 1, 3 rounds, `packed` byte-identical) and
          `wave_w28_tail16+quant` at 255 leaves (K5 at 28 slots, unfused
          byte-identical).  Round times, the quantize step's and K5's
          share, one profiled round of the main run and one of
          `strict+quant`.
  threefry the threefry kernel (`csrc/threefry.cu`, which every draw of
          `ops/threefry.py` launches on a CUDA device) bitwise its plain
          version (torch ops) on the card and on the CPU: bits and
          uniforms under 4 keys at n = 1, 31 and 2M + 3, and a 509 x 28
          batch with one key a row (a 255-leaf tree's node ids by the
          features) with the permutations sorted from it.  Then the 2M
          uniform, the 2M bits and the batch timed L2-warm (queued
          behind a spin kernel) beside the bound of their operations
          (the INT32 lanes' share, or the schedulers' dispatch) and bytes,
          and the plain version; the kernel's SASS instruction mix
          (`cuobjdump -sass` of its build), a hash's share apart.
  train_sampled the samplers on the train phase's data: (a) bagging 0.8
          every round and feature_fraction 0.8 on the bench's wave, f32
          (the main run: per round one threefry launch for the bag and
          one for the tree's features) and quantized (two more, the
          quantizer's), each round's bag and each tree's feature mask
          on the card bitwise the CPU's from the same keys, two runs and
          the unfused run byte-identical, held-out AUC within 0.02 of
          the unsampled f32 wave's; (b) GOSS as
          `benchmarks/bench_families.py` runs it, 14 rounds (rounds
          10-13 sample): each sampled round's weights bitwise the CPU's
          from the card's gradients, two runs byte-identical, quantized
          GOSS on the f32 histograms with the reference's warning; (c)
          feature_fraction_bynode 0.5 and extra_trees on the strict
          grower at 255 leaves, 3 rounds: every tree's node masks (one
          batched draw a sampler a tree) bitwise the CPU's, one host
          sync a split and one a tree as unsampled, two runs
          byte-identical.
  train_categorical the repo's `categorical_efb` family
          (`benchmarks/bench_families.py`, Criteo-like: 13 numerical
          and 26 categorical columns of 3 to 10,000 levels; 500,000
          rows, 50,000 held out) on the bench's wave, 10 rounds.  (a)
          The 39 columns as published: two fused runs (K2/K3) and an
          unfused run (K1 and the torch search) byte-identical, per
          round K2 launches = 1 + waves that built histograms, K3
          launches and host syncs as in train_wave (the categorical
          search, torch ops on the carried histograms, adds no launch);
          held-out AUC within 1e-3 of hist_impl=segment_sum; quantized
          (K5/K3) within 0.02; strict at 255 leaves, 3 rounds, K1
          launches = 255 a round; served on the card bitwise the host
          walk; the categorical splits by case and the largest bitset.
          (b) The one-hot variant (the 8 categoricals of at most 40
          levels as 0/1 columns, 170 columns), which EFB bundles: the
          wave unfused on K1 over the bundle columns, two runs
          byte-identical, quantized on K4, held-out AUC within 1e-3 of
          the same bins unbundled, served bitwise the host walk.  Round
          times, binning seconds, the categorical search's share of a
          round (CUDA events around its calls) and one profiled round
          of (a).  Its launches go on its own line.
  train_api the user API around training on the train phase's data at
          the bench's wave configuration, a line a step: (a) 5 rounds
          saved, then 5 more from the file (`init_model`): the first 5
          tree blocks byte-identical, the uploaded train score bitwise
          the f32 cast of the init model's `predict(raw_score=True)`,
          held-out AUC within 1e-3 of 10 uninterrupted rounds, per round
          K2, K3 and syncs as train_wave's; (b) 6 updates with the
          held-out set, rolled back once (model text that of 5 updates,
          scores within the f32 rounding of (s + c) - c) and again (the
          bin-level replay, 4 updates' text); (c) `add_valid` of 50,000
          held-out rows after 5 updates, the card's replay bitwise the
          CPU's, the rows that differ from a booster that had them from
          the start counted; (d) `refit` on the held-out rows on the
          card and on the CPU, model texts byte-identical, a link launch
          a round; (e) `reset_parameter` (learning rate 0.1 * 0.95^i,
          num_leaves 31 then 15 from round 5): the shrinkage lines follow
          it, trees 6-10 within 15 leaves, K2 a round that of a fresh
          booster; (f) `cv` (3 stratified folds on the 2M rows, AUC, 10
          rounds, early stopping 3): each round's mean and stdv bitwise
          `_agg_cv_result` over three `train` runs on the same subsets,
          K2 launches equal; (g) `LGBMClassifier` with scikit-learn's
          import hidden: its model text `train`'s with the estimator's
          params, and its trees those of the 10-round WAVE_PARAMS run,
          `predict_proba` bitwise `Booster.predict` stacked.  Then the phase's seconds by step and launches.
  train_breadth the grower's constraints and the boosting modes on the
          train phase's data, the bench's wave (10 rounds) or the strict
          grower at 255 leaves (3 rounds), a line a run: (a) monotone
          basic [1, -1, 1, -1, 0, ...] on the wave, f32 (K1) and
          quantized (K4); (b) intermediate, strict, with bynode 0.5; (c)
          interaction constraints (four groups of 7) with CEGB (split
          1e-6, a coupled vector) on the fused wave (K2/K3) and quantized
          (K5/K3); (d) forced splits (the root and both children) on the
          wave and the strict grower; (e) the histogram pool at 8 slots,
          strict, beside the unpooled run; (f) DART (drop_rate 0.1,
          skip_drop 0.5); (g) RF (bagging 0.8 every round,
          feature_fraction 0.8); (h) linear trees (linear_lambda 0.01, 5
          rounds: the host fit binds);
          (i) a numpy binary logloss as `fobj`.  Each: two runs
          byte-identical, held-out AUC within 1e-3 of
          hist_impl=segment_sum, served by ServingRuntime on its rung
          bitwise the host walk, its kernels launched every round (the
          fused runs' K2/K5 = 1 + waves and K3 = waves); the monotone
          grids (1,000 held-out rows x 64 points) without a violation,
          IC paths inside one group, every tree led by the forced
          splits, the pool's slots in [1, 254] and its trees the
          unpooled run's up to near-ties (the trees that differ counted),
          DART's drops and RF's average_output with a
          bitwise text round trip.  Per run ms a round beside the plain
          wave's, launches and syncs a tree, policy, hist_impl, the
          linear fit's host seconds.
  train_objectives the regression family (L1, quantile 0.7, MAPE,
          Huber, Fair, Poisson, gamma, Tweedie 1.5), the two
          cross-entropies and one-vs-all (3 classes) on the train
          phase's bins with a label a objective (not re-binned), the
          bench's wave, 5 rounds, f32 (K2/K3) and quantized L1 and
          Poisson (K5/K3), a line a run: two runs byte-identical, the
          objective's metric on the held-out rows within 1e-3 relative
          of hist_impl=segment_sum, the L1 family's renewed leaves
          bitwise the CPU's plain percentile, served bitwise the host
          walk; ms a round beside the plain wave's.
  train_rank lambdarank and rank_xendcg on a synthetic set at
          MSLR-WEB10K's width and scale (136 features, about 720,000
          rows in 6,000 queries, median 110 documents, the longest 900;
          1,000 held-out queries), the bench's wave with eval_at
          1/3/5/10, 10 rounds: lambdarank twice, with segment_sum,
          quantized, rank_xendcg (a threefry launch a bucket a round),
          with positions.  Gates: byte-identical runs, held-out NDCG@10
          within 1e-3 of segment_sum and above round 1's, the lambdas at
          round 1 and 5 within rtol 1e-5 of the CPU's, the propensities
          anchored and finite, every model served bitwise the walk; ms a
          round, the lambdas' share of a round and their launches.
  train_sparse a seeded CSR matrix of 200,000 x 1,000 at 0.5% density,
          the bench's wave, 10 rounds: built without a dense bin matrix
          and bundled by EFB, its model byte for byte the dense form's
          and the binary cache's, served bitwise the walk; the binning
          seconds of both forms.
  train_files the host library (`native/libnative.cpp`: compiler,
          OpenMP, build seconds); the train phase's binning split into
          the greedy bin search and the value-to-bin pass, the pass
          through the library and its plain numpy version (the same
          codes); the first FILE_ROWS rows written as CSV (a header),
          TSV and LibSVM at 17 significant digits, each trained with the
          bench's wave (CSV also two_round, and two_round into the shard
          store), every model text the array's, the same K2/K3 launches
          a round; predictions from the CSV bitwise the array's (host
          walk, numpy walk, device_predict), the two walks timed (also
          on the main phase's forest at 1, 256, 4096 rows); the
          2M rows spilled to the shard store at the default budget and
          at 31 shards, assembled on the card, the in-memory model (the
          train phase's Dataset) and launches; spill, assembly (GB/s
          beside the PCIe link), prefetch figures; a flipped shard byte
          raises naming the file.
  train_stream the shard-streamed grower and the memory ledger.  The
          carry entries (`lgbt_histogram_carry`, K1's order a shard at a
          time in two launches, a running prefix and one open piece
          carried; `lgbt_histogram_carry_q`, one launch a shard into
          int32 cells) on 200,000 of the bench's rows in 7 uneven
          shards at S = 1, 3, 8: the f32 carry bitwise its order-exact
          model and K1 over all rows, the int32 carry bitwise K4 over
          all rows, each within its tolerance of its plain carry; a
          shard's fold timed (device time behind a spin kernel, fresh
          carries made outside the timed passes, and the host's pace)
          beside its bound, the plain carry and `index_add_` (device
          time), the profiler's kernels a shard; the same at the paths'
          shapes, the 2M rows in shards of 65,536 at S = 1 and 8 and a
          1M-row fold at S = 8, each pass bitwise K1 (K4).  The 2M rows
          spilled
          in 31 shards and trained streamed (the bench's wave under
          "auto" over a 16 MB budget, 5 rounds; leafwise strict, 2; the
          quantized wave, 3), each model byte for byte the in-memory
          one trained here; K3's candidates on K2's and K5's histograms
          bitwise theirs; staging within the budget and the peak
          allocation below the in-memory run's by half the bins; round
          ms, sweeps a tree, launches a round, the pass stages, the
          store's read rate, prefetch figures; the ledger's reconcile
          against `torch.cuda.memory_stats` and its owners.  serve_plane
          also reads `GET /debug/memory`: 200, the model's planes within
          the allocator's bytes.
  train_dist distributed training on two gloo ranks, processes of this
          script (`--dist-worker`) that share the one GPU (compute mode
          Default, read first), each holding half of the 2M rows from
          one `save_binary` file: `tree_learner=data` on the bench's
          wave (5 rounds; the ring of f32 carries, K3 on the finalized
          histograms), the quantized wave (3; the int32 carries summed)
          and strict at 31 leaves (2), the feature learner (2; K1 on a
          rank's block under the whole matrix's plan) and voting
          (top_k 10, 2): data and feature models byte for byte the
          serial card models trained first, voting's held-out AUC within
          1e-3; carry launches on each rank; a hop of the f32 carry at
          most 1,500,000 B; round ms beside the serial rounds, hops a
          tree, bytes a hop, the D2H / gloo / H2D
          seconds, each rank's peak allocation.
  serve_sharded main's model on two replicas of the GPU
          (`devices=[cuda:0, cuda:0]`): bitwise the one-device runtime at
          1, 256, 4096 rows and ragged tails; `serve_shard_devices=2`
          raises at load on a one-GPU card; p50 in turns.
  compare (with --phases and --baseline DIR only) K1, K2, K3, K4, K5,
          the link kernel and the quantize step of this checkout and of
          the checkout in DIR on the same inputs: K1 and K2 agree within
          twice their tolerance, K3 (S = 1, 8, 14, 42, u16), K4, K5, the
          link and the quantize step bitwise; each timed in turns (this,
          DIR, DIR, this), the link also with L2 flushed; both carries
          (200,000 rows in 7 shards at S = 1 and 8, the 2M rows in
          shards of 65,536 at S = 8) bitwise DIR's, a shard timed in
          turns, each design's kernels by the profiler; then
          compare_serving.
  compare_serving (with --phases and --baseline DIR only) the main
          phase's model at 1, 256 and 4096 rows: the standalone K6 and
          sum of both checkouts bitwise, this checkout's fused request
          program bitwise DIR's `compiled_predict`, the stacked
          traversal and the bounded sum bitwise DIR's, each timed in
          turns (those two also L2-flushed); then a converted request
          through each checkout's ServingRuntime on the compiled,
          device_sum and bounded rungs, bitwise, its p50 in turns; then
          each checkout's `device_predict` (its own Booster), bitwise,
          a raw request's p50 in turns at 1, 256 and 4096 rows and its
          device program (this checkout's `serve_forest_f32` over its
          records, DIR's `predict_raw_f32` over its planes) in turns,
          warm and L2-flushed, there and at 65,536 rows.
  kernels one line per kernel: launches on its path's phase (the fused
          serving kernel and the link: main, where the standalone
          traverse and accumulate show 0 and their golden-phase and
          predict_api launches beside; the fused kernel's f32 instance:
          predict_api; the f32 sum: predict_api's stacked route; the
          stacked traversal and the bounded sum: serve_plane;
          histogram: train; fused_hist_split and
          split_scan: train_wave; fused_hist_split_q: train_quant's main
          run; histogram_q: its strict run; threefry: train_sampled's
          main run, with train_quant's quantizer launches beside;
          K2, K3, K1 and the link also show their train_api launches,
          K1-K5 their train_breadth, train_objectives, train_rank,
          train_sparse and train_files launches, threefry its train_rank
          launches; the two carry entries: train_stream's streamed
          runs; K1, the carries, K3 and the link also their two ranks'
          train_dist launches, the fused serving kernel its
          serve_sharded launches),
          parity, times, bound.
  walls   each phase's seconds (from the previous phase's last line to
          its own, its kernels' builds included) and the script's.

Then the card's name and power limit as nvidia-smi prints them, and as
the last line `{"ok": true, "device": {...}}`.  Any failure exits
non-zero without that line.  Needs one CUDA card; imports nothing of
JAX and nothing of `lightgbm_tpu`.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = ("binary", "categorical", "goss_bagging", "multiclass",
          "regression_l2")

# H100 SXM peaks at the 700 W limit (NVIDIA data sheet and Hopper white
# paper): HBM3 bandwidth; 67 TFLOP/s f32 outside the tensor cores is
# 132 SMs x 128 f32 lanes x 2 (FMA) x 1.98 GHz.  An SM has 64 INT32
# lanes and 64 FP64 lanes, so one-operation instructions (an integer op,
# an f64 add) peak at 132 x 64 x 1.98 GHz = 16.7e12 per second.
# Each SM's four schedulers dispatch one 32-lane warp instruction a clock,
# 132 x 128 x 1.98 GHz lane-instructions a second; nvcc can dispatch an
# integer add as IMAD on the f32 multiply-add lanes, beside the INT32
# lanes' shifts and logic, so adds count against the dispatch rate only.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
DISPATCH_LANES_PER_S = 132 * 128 * 1.98e9
F64_ADDS_PER_S = 132 * 64 * 1.98e9
F32_OPS_PER_S = 67e12
#: kernels held to their plain versions within a tolerance (the rest
#: bitwise): float sums in another order than the plain version's
WITHIN_TOL = ("histogram", "fused_hist_split", "histogram_carry")
#: wide synthetic models of the golden phase, (name, features): 64
#: features put a 256-row block's rows above the 48 KB of shared memory
#: a launch gets by default (the kernel opts in to more), 300 features
#: above the 227 KB a block can have (rows are read from global memory)
WIDE = (("wide_64", 64), ("wide_300", 300))


# ----------------------------------------------------------- model + data
def _feature_kind(f: int) -> int:
    """Higgs-like feature families: 0 momenta/masses (log-normal,
    positive), 1 pseudorapidities (normal), 2 azimuths (uniform on
    [-pi, pi]), 3 b-tags (three discrete values, mostly zero)."""
    return f % 4


def request_rows(rng: np.random.RandomState, n: int,
                 num_features: int = 28) -> np.ndarray:
    """Request rows from the synthetic model's input distribution, with
    about 2% NaN in the azimuth features.  Values are f32-representable,
    so the f32 staging is exact and the f64 host walk routes them as the
    card does."""
    X = np.empty((n, num_features), np.float64)
    for f in range(num_features):
        kind = _feature_kind(f)
        if kind == 0:
            col = rng.lognormal(0.0, 0.5, n)
        elif kind == 1:
            col = rng.normal(0.0, 1.0, n)
        elif kind == 2:
            col = rng.uniform(-np.pi, np.pi, n)
            col[rng.rand(n) < 0.02] = np.nan
        else:
            col = rng.choice([0.0, 1.0865, 2.1731], n, p=[0.6, 0.2, 0.2])
        X[:, f] = col
    return X.astype(np.float32).astype(np.float64)


def _grow_tree(rng, num_leaves, num_features, grids):
    """One leaf-wise tree: each step splits the leaf holding the most
    simulated rows, by a random fraction, so depths come out uneven as
    in real leaf-wise growth.  Child encoding as LightGBM's
    `Tree::Split`: the split leaf keeps its index as the left child and
    the new leaf (step + 1) becomes the right child."""
    ni = num_leaves - 1
    feat = np.zeros(ni, np.int64)
    thr = np.zeros(ni, np.float64)
    dtype = np.zeros(ni, np.int64)
    left = np.zeros(ni, np.int64)
    right = np.zeros(ni, np.int64)
    counts = [1.0]
    owner = {0: (-1, 0)}             # leaf -> (parent node, side)
    for i in range(ni):
        leaf = int(np.argmax(counts))
        frac = rng.uniform(0.05, 0.95)
        f = rng.randint(num_features)
        feat[i] = f
        thr[i] = grids[f][rng.randint(len(grids[f]))]
        missing_type = rng.randint(3)         # None, Zero, NaN
        default_left = rng.randint(2)
        dtype[i] = (missing_type << 2) | (default_left << 1)
        left[i] = ~leaf
        right[i] = ~(i + 1)
        parent, side = owner[leaf]
        if parent >= 0:
            (left if side == 0 else right)[parent] = i
        owner[leaf] = (i, 0)
        owner[i + 1] = (i, 1)
        c = counts[leaf]
        counts[leaf] = c * frac
        counts.append(c * (1.0 - frac))
    leaf_value = rng.normal(0.0, 0.05, num_leaves)
    return feat, thr, dtype, left, right, leaf_value, np.asarray(counts)


def synthetic_forest_text(seed: int = 0, num_trees: int = 500,
                          num_leaves: int = 255,
                          num_features: int = 28) -> str:
    """LightGBM model text of a binary (`sigmoid:1`) forest made from
    `seed`.  Thresholds are drawn from per-feature 255-bin quantile
    grids of `request_rows`' distribution; missing types None, Zero
    and NaN are mixed with default_left both ways; leaf values are
    full-precision f64."""
    rng = np.random.RandomState(seed)
    sample = request_rows(rng, 100_000, num_features)
    grids = []
    for f in range(num_features):
        col = sample[:, f][~np.isnan(sample[:, f])]
        q = np.quantile(col, np.linspace(0.0, 1.0, 256)[1:-1])
        grids.append(np.unique(q.astype(np.float32)).astype(np.float64))

    def fmt(a):
        return " ".join(f"{float(v):.17g}" for v in a)

    def ints(a):
        return " ".join(str(int(v)) for v in a)

    trees = []
    for t in range(num_trees):
        feat, thr, dtype, left, right, lv, cnt = _grow_tree(
            rng, num_leaves, num_features, grids)
        ni = num_leaves - 1
        trees.append("\n".join([
            f"Tree={t}", f"num_leaves={num_leaves}", "num_cat=0",
            f"split_feature={ints(feat)}",
            f"split_gain={fmt(np.ones(ni))}",
            f"threshold={fmt(thr)}", f"decision_type={ints(dtype)}",
            f"left_child={ints(left)}", f"right_child={ints(right)}",
            f"leaf_value={fmt(lv)}", f"leaf_weight={fmt(cnt * 1e3)}",
            f"leaf_count={ints(np.maximum(cnt * 1e6, 1))}",
            f"internal_value={fmt(np.zeros(ni))}",
            f"internal_weight={fmt(np.ones(ni))}",
            f"internal_count={ints(np.ones(ni))}",
            "is_linear=0", "shrinkage=1", "", ""]))
    names = " ".join(f"Column_{i}" for i in range(num_features))
    header = "\n".join([
        "tree", "version=v4", "num_class=1", "num_tree_per_iteration=1",
        "label_index=0", f"max_feature_idx={num_features - 1}",
        "objective=binary sigmoid:1", f"feature_names={names}",
        "feature_infos=" + " ".join(["none"] * num_features),
        "tree_sizes=" + " ".join(str(len(s) + 1) for s in trees), "", ""])
    footer = ("end of trees\n\nparameters:\n[objective: binary]\n"
              f"[num_leaves: {num_leaves}]\n[num_iterations: {num_trees}]\n"
              "[max_bin: 255]\nend of parameters\n\npandas_categorical:null\n")
    return header + "\n".join(trees) + footer


def adversarial_rows(trees, num_features: int, seed: int = 0) -> np.ndarray:
    """f64 rows that stress routing: every feature at NaN, +-inf, +-0,
    f32 subnormals, the f32 zero threshold 1e-35 and its neighbours,
    categorical edge values (-0.5, -1, 31.9, 32, 1e9), and f64 values
    that saturate to +-inf in the f32 cast; then rows whose features sit
    exactly at the model's thresholds (the f64 value, its f32 rounding
    and the next f32 values up and down), sprinkled with the specials."""
    f32 = np.float32
    z = f32(1e-35)
    specials = np.array([
        np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-40, -1e-40, 1e-45, -1e-45,
        float(np.nextafter(f32(1.1754944e-38), f32(0))), float(z),
        float(np.nextafter(z, f32(1))), float(np.nextafter(z, f32(0))),
        -float(z), -0.5, -1.0, -1.5, 0.5, 31.9, 32.0, 63.0, 64.0, 1e9,
        1e39, -1e39, 3.5e38, 1e300, -1e300], np.float64)
    rows = [np.full(num_features, v) for v in specials]
    thr = [np.asarray(t.threshold[:max(t.num_leaves - 1, 0)], np.float64)
           for t in trees]
    feats = [np.asarray(t.split_feature[:max(t.num_leaves - 1, 0)])
             for t in trees]
    thr = np.concatenate(thr) if thr else np.zeros(0)
    feats = np.concatenate(feats) if feats else np.zeros(0, np.int64)
    rng = np.random.RandomState(seed)
    n_thr = 128
    X = rng.randn(n_thr, num_features)
    for f in np.unique(feats):
        v = thr[feats == f]
        t32 = v.astype(f32)
        cand = np.concatenate([
            v, t32.astype(np.float64),
            np.nextafter(t32, f32(np.inf)).astype(np.float64),
            np.nextafter(t32, f32(-np.inf)).astype(np.float64)])
        X[:, f] = cand[rng.randint(len(cand), size=n_thr)]
    mask = rng.rand(n_thr, num_features) < 0.1
    X[mask] = specials[rng.randint(len(specials), size=int(mask.sum()))]
    return np.ascontiguousarray(np.vstack(rows + [X]))


# --------------------------------------------------------------- helpers
class Failure(Exception):
    pass


def _check(cond, msg):
    if not cond:
        raise Failure(msg)


#: (phase, seconds since the script started) at each phase line
_EMITTED = []
_T0 = time.perf_counter()


def _emit(obj):
    if "phase" in obj:
        _EMITTED.append((obj["phase"], time.perf_counter() - _T0))
    print(json.dumps(obj, sort_keys=False), flush=True)


def _phase_walls():
    """Seconds from the previous phase's last line to each phase's last
    line (the phase with its kernels' builds), and the script's so far."""
    last = {}
    for name, t in _EMITTED:
        last[name] = t
    walls, prev = {}, 0.0
    for name, t in sorted(last.items(), key=lambda kv: kv[1]):
        walls[name] = t - prev
        prev = t
    return {"s": walls, "total_s": time.perf_counter() - _T0}


def _cuda_ms(fn, iters=20, warmup=3, queued=False, flush=None):
    """Mean time of fn() over `iters` runs, from CUDA events.  With
    `queued`, a spin kernel holds the stream until every run has been
    submitted, so the events read the device's time and not the pace at
    which the host submits (for kernels shorter than their launch's host
    cost); the spin is lengthened until the runs were all queued.  With
    `flush`, flush() runs before each run, outside its events (the L2
    cold: `_flusher`)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = 2_000_000
    while True:
        events = []
        if queued:
            torch.cuda._sleep(cycles)
        for i in range(iters if flush is not None else 1):
            if flush is not None:
                flush()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(1 if flush is not None else iters):
                fn()
            end.record()
            events.append((start, end))
        ahead = not events[0][0].query()
        torch.cuda.synchronize()
        if not queued or ahead:
            return sum(s.elapsed_time(e) for s, e in events) / iters
        _check(cycles < 1 << 34, "timing: the runs could not be queued "
               "ahead of the card")
        cycles *= 4


def _max_abs_diff(a, b):
    """Largest |a - b| over the elements; elements that are equal, or
    both NaN, count 0 (so -inf against -inf is 0), a NaN against a
    number counts inf."""
    import torch
    a, b = a.float(), b.float()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    d = torch.where(same, torch.zeros_like(a), (a - b).abs())
    return float(torch.nan_to_num(d, nan=float("inf")).max())


def _bits_equal(a, b):
    a = np.asarray(a)
    b = np.asarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    view = {8: np.uint64, 4: np.uint32}[a.dtype.itemsize]
    return bool(np.array_equal(a.view(view), b.view(view)))


def _max_abs_err(a, b) -> float:
    """Largest |a - b| over equal-shaped arrays, where two NaNs and two
    equal infinities differ by 0 and any other pair with a NaN or an
    infinity by inf."""
    with np.errstate(invalid="ignore"):      # casts of signalling NaNs
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        if a.shape != b.shape:
            return float("inf")
        d = np.abs(a - b)
    same = (a == b) | (np.isnan(a) & np.isnan(b))
    d = np.where(same, 0.0, np.where(np.isnan(d), np.inf, d))
    return float(d.max()) if d.size else 0.0


def _traverse(rt, Xd, fn, **kw):
    """Xd through every depth bucket of rt's plan with `fn`, the traverse
    kernel's wrapper or its plain version: the per-bucket slots."""
    st = rt._state
    return [fn(Xd, w, k, p, c, d, m, **kw)
            for (w, k, p, c), (d, m) in zip(st.planes, st.meta)]


def _plain_predict(rt, Xd):
    """The compiled path with the plain versions of the standalone
    kernels (the JAX layout), on Xd's device: (slots, raw f64 sums)."""
    from lightgbm_tpu_torch.compiler.kernel import traverse_bucket_plain
    from lightgbm_tpu_torch.ops.predict import accumulate_slots_exact_plain
    import torch
    st = rt._state
    slots = torch.cat(_traverse(rt, Xd, traverse_bucket_plain))
    acc = accumulate_slots_exact_plain(slots, st.gidx,
                                       st.export["value_f64"],
                                       st.export["num_class"], st.cls)
    return slots, acc


def _serve(rt, Xd, plain=False, **kw):
    """The fused entry (or its plain version, over the same records) on
    Xd: the raw f64 sums."""
    from lightgbm_tpu_torch.compiler import kernel
    st = rt._state
    fn = kernel.serve_forest_plain if plain else kernel.serve_forest
    return fn(Xd, st.records, st.export["value_f64"],
              st.export["num_class"], **kw)


def _forest_plan(rt, Xd, **kw):
    """The fused kernel's launch plan for Xd on rt's model (`kw`: the
    plan's requests)."""
    from lightgbm_tpu_torch.compiler.records import forest_plan
    rec = rt._state.records
    b, f = Xd.shape
    return forest_plan(b, f, rec.meta.shape[0], rec.ni_max, rec.mw,
                       rt._state.export["num_class"], **kw)


#: the fused kernel's launch variants the golden phase runs: (cluster,
#: stage, rows_smem, ilp) requests
FUSED_VARIANTS = tuple((c, s, r, i) for c in (1, 8) for s in (False, True)
                       for r in (True, False) for i in (1, 2, 4))
#: the launch plans the main phase times at each size: (cluster, rows,
#: ilp, threads, stage) requests, rows cut to the batch
FUSED_SWEEP = tuple((c, r, i, 512, False) for c in (1, 2, 8)
                    for r in (1, 4, 16, 64, 256) for i in (1, 2, 4)) + tuple(
    (c, r, i, 512, True) for c in (1, 2, 4, 8) for r in (16, 32, 64, 128, 256)
    for i in (1, 2))


def _leaf_depths(trees, nl):
    """[T, NL] number of internal nodes on the path to each leaf."""
    out = np.zeros((len(trees), nl), np.int64)
    for i, t in enumerate(trees):
        k = t.num_leaves - 1
        if k <= 0:
            continue
        stack = [(0, 1)]
        while stack:
            nd, d = stack.pop()
            for c in (int(t.left_child[nd]), int(t.right_child[nd])):
                if c < 0:
                    out[i, ~c] = d
                else:
                    stack.append((c, d + 1))
    return out


# ---------------------------------------------------------------- phases
def phase_env():
    import torch
    from lightgbm_tpu_torch.compiler import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    from lightgbm_tpu_torch import native
    t0 = time.perf_counter()
    built = _build.build_all()
    build_s = time.perf_counter() - t0
    _check(set(built) == {"traverse", "accumulate", "serve", "histogram",
                          "histogram_q", "fused_split", "links",
                          "threefry", "stacked", "bounded"},
           f"build_all built {sorted(built)}")
    # the host library (g++), built before any binning or host walk
    host_library = native.lib_info()
    _emit({"phase": "env", "torch": torch.__version__,
           "cuda": torch.version.cuda,
           "device": torch.cuda.get_device_name(0),
           "device_count": torch.cuda.device_count(),
           "nvidia_smi": smi.stdout.strip(), "build_s": build_s,
           "compiled": {n: b.compiled for n, b in built.items()},
           "entries": {n: [sym for sym, _ in _build._SIGNATURES[n]]
                       for n in built},
           "ptxas": {n: b.ptxas for n, b in built.items()},
           "host_library": host_library,
           "empty_launch_ms": empty_launch_ms()})
    return smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""


def empty_launch_ms(device=None):
    """Device time of one launch of an empty kernel (torch's spin kernel
    asked for 0 cycles), queued behind a spin kernel as the short kernels
    are timed: the floor a few-microsecond kernel's time is read
    against."""
    import torch
    with torch.cuda.device(device or 0):
        return _cuda_ms(lambda: torch.cuda._sleep(0), iters=100,
                        queued=True)


def _golden_batches(rt, ex, nf, wide):
    """The golden phase's batches for one model: the probe rows plus
    the adversarial rows; for a WIDE model also those rows repeated to
    4096, where the fused plan takes its largest row blocks."""
    X = np.vstack([rt._probe_batch(ex, 256), adversarial_rows(ex["trees"],
                                                              nf)])
    out = [X]
    if wide:
        out.append(np.resize(X, (4096, X.shape[1])))
    return out


def phase_golden(seed, device=None):
    """The five golden models, then the WIDE synthetic models, through
    all three entries on every launch branch: the fused entry at its
    default plan and at each of FUSED_VARIANTS, bitwise its plain
    version (which reads the same records) and the standalone kernels'
    plain versions (which read the JAX layout); the standalone traverse
    with its rows in shared and in device memory, and the standalone
    sum, bitwise their plain versions.  Returns the standalone kernels'
    launch counts of this phase."""
    import torch
    from lightgbm_tpu_torch import Booster, ServingRuntime
    from lightgbm_tpu_torch.compiler import kernel
    from lightgbm_tpu_torch.compiler.records import traverse_plan
    from lightgbm_tpu_torch.ops import predict
    report = {"phase": "golden", "models": {}}
    models = [(name, Booster(model_file=os.path.join(
        ROOT, "tests", "data", f"golden_{name}.model.txt")), False)
        for name in GOLDEN]
    models += [(name, Booster(model_str=synthetic_forest_text(
        seed, num_trees=20, num_leaves=63, num_features=f)), True)
        for name, f in WIDE]
    kernel.TRAVERSE_LAUNCHES = 0
    predict.ACCUMULATE_LAUNCHES = 0
    fused_branches, trav_branches = set(), set()
    optin = {"fused": False, "traverse": False}
    for name, bst, wide in models:
        rt = ServingRuntime(bst, tile_vmem_kb=1, device=device)
        cpu = ServingRuntime(bst, tile_vmem_kb=1, device="cpu")
        st = rt._state
        ex = st.export
        K = ex["num_class"]
        nf = max(bst.num_feature(), ex["stacked"]["min_features"])
        entry = {"tiles": st.plan.num_tiles(),
                 "buckets": [int(d) for d, _ in st.meta],
                 "mw": int(st.records.mw), "K": int(K), "batches": []}
        for X in _golden_batches(rt, ex, nf, wide):
            Xd = rt._stage32(X, rt._chunk_rows(X.shape[0]))
            slots_p, acc_p = _plain_predict(rt, Xd)
            want = acc_p.cpu().numpy()
            _check(_bits_equal(_serve(rt, Xd, plain=True).cpu().numpy(),
                               want),
                   f"{name}: the fused plain version != the standalone "
                   f"plain versions")
            runs = [("default", _forest_plan(rt, Xd))]
            runs += [(f"c{c}_{'staged' if s else 'l1'}_"
                      f"{'rsmem' if r else 'rglobal'}_ilp{i}",
                      _forest_plan(rt, Xd, cluster=c, stage=s, rows_smem=r,
                                   ilp=i))
                     for c, s, r, i in FUSED_VARIANTS]
            plans = {}
            for label, plan in runs:
                got = _serve(rt, Xd, plan=plan).cpu().numpy()
                _check(_bits_equal(got, want),
                       f"{name}, {Xd.shape[0]} rows: the fused kernel "
                       f"({plan.branch()}) != plain")
                fused_branches.add(plan.branch())
                optin["fused"] |= plan.optin
                plans[label] = plan._asdict()
            trav = []
            for rows_smem in (None, False):
                tplan = traverse_plan(Xd.shape[0], Xd.shape[1],
                                      st.planes[0][0].shape[1],
                                      st.planes[0][0].shape[0],
                                      rows_smem=rows_smem)
                slots = torch.cat(_traverse(rt, Xd, kernel.traverse_bucket,
                                            plan=tplan))
                _check(torch.equal(slots, slots_p),
                       f"{name}: traverse kernel ({tplan.branch()}) slots "
                       f"!= plain")
                trav_branches.add(tplan.branch())
                optin["traverse"] |= tplan.optin
                trav.append(tplan.branch())
            acc_k = predict.accumulate_slots_exact(
                slots_p, st.gidx, ex["value_f64"], K, st.cls).cpu().numpy()
            _check(_bits_equal(acc_k, want),
                   f"{name}: accumulate kernel != plain")
            entry["batches"].append({
                "rows": int(X.shape[0]), "device_rows": int(Xd.shape[0]),
                "features": int(Xd.shape[1]), "fused_plans": plans,
                "traverse_branches": trav})
        X = _golden_batches(rt, ex, nf, False)[0]
        raw = rt.predict(X, raw_score=True)
        _check(_bits_equal(raw, cpu.predict(X, raw_score=True)),
               f"{name}: GPU raw scores != CPU plain path")
        conv = rt.predict(X)
        conv_cpu = cpu.predict(X)
        ulp = int(np.max(np.abs(conv.view(np.int32).astype(np.int64)
                                - conv_cpu.view(np.int32).astype(np.int64))))
        _check(ulp == 0, f"{name}: GPU converted scores differ from the "
               f"CPU plain path by up to {ulp} ulp")
        if name == "categorical":
            _check(st.records.mw > 0,
                   "categorical model did not run the bitset branch")
        if name == "multiclass":
            _check(K == 3, "multiclass model is not K=3")
        entry.update({"raw_equal_cpu": True,
                      "converted_max_ulp_vs_cpu": ulp})
        report["models"][name] = entry
    want_fused = {f"{c}/{s}/{r}" for c in ("cluster", "single")
                  for s in ("staged", "l1")
                  for r in ("rows_smem", "rows_global")}
    _check(fused_branches == want_fused and optin["fused"],
           f"golden phase missed a fused launch branch: {fused_branches}, "
           f"opt-in {optin['fused']}")
    _check(trav_branches == {"rows_smem", "rows_global"}
           and optin["traverse"],
           f"golden phase missed a traverse launch branch: {trav_branches}"
           f", opt-in {optin['traverse']}")
    launches = {"traverse": kernel.TRAVERSE_LAUNCHES,
                "accumulate": predict.ACCUMULATE_LAUNCHES}
    _check(all(v > 0 for v in launches.values()),
           f"golden phase did not launch the standalone kernels: {launches}")
    report.update({"fused_branches": sorted(fused_branches),
                   "traverse_branches": sorted(trav_branches),
                   "optin": optin, "launches": launches})
    _emit(report)
    return launches


def _flusher(device):
    """A function that evicts the card's 50 MB L2: it writes 256 MB."""
    import torch
    buf = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    return buf.zero_


def _bound(nbytes, ops, rate):
    """(bound ms, bound_by) of `nbytes` moved and `ops` at `rate`."""
    t_b = nbytes / HBM_BYTES_PER_S
    t_o = ops / rate
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def _request_breakdown(rt, X, iters=20):
    """One converted request of X's rows, staged as `_compiled_chunk`
    stages it, split into its stages by CUDA events and the host clock:
    the host's f32 staging, the copy to the card, the fused kernel, the
    link and the copy back (medians over `iters`, device ms between
    events and host ms around each stage)."""
    import torch
    from lightgbm_tpu_torch.compiler.kernel import serve_forest
    st = rt._state
    ex = st.export
    conv = rt._booster.objective_.convert_output
    names = ("host_stage", "h2d", "serve", "link", "d2h")
    dev_ms = {n: [] for n in names[1:]}
    host_ms = {n: [] for n in names}
    for _ in range(iters + 2):
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        h = [time.perf_counter()]
        buf = np.zeros((rt._chunk_rows(X.shape[0]), X.shape[1]), np.float32)
        buf[:X.shape[0]] = X
        h.append(time.perf_counter())
        ev[0].record()
        Xd = torch.from_numpy(buf).to(rt.device)
        ev[1].record()
        h.append(time.perf_counter())
        raw = serve_forest(Xd, st.records, ex["value_f64"], ex["num_class"])
        ev[2].record()
        h.append(time.perf_counter())
        out = conv(raw.to(torch.float32))
        ev[3].record()
        h.append(time.perf_counter())
        out[:X.shape[0]].cpu().numpy()
        ev[4].record()
        h.append(time.perf_counter())
        torch.cuda.synchronize()
        for i, n in enumerate(names):
            host_ms[n].append((h[i + 1] - h[i]) * 1e3)
        for i, n in enumerate(names[1:]):
            dev_ms[n].append(ev[i].elapsed_time(ev[i + 1]))
    return {"device_ms": {n: float(np.median(v[2:]))
                          for n, v in dev_ms.items()},
            "host_ms": {n: float(np.median(v[2:]))
                        for n, v in host_ms.items()}}


#: the request sizes at which the main phase times each serving kernel
TIMED_ROWS = (1, 256, 4096)
#: a full `device_predict` chunk, where compare_serving also times the
#: two checkouts' device programs
PREDICT_F32_ROWS = 65_536


def phase_main(seed, kernel_module, predict_module):
    import torch
    from lightgbm_tpu_torch import Booster, ServingRuntime
    from lightgbm_tpu_torch.ops import xla_math
    text = synthetic_forest_text(seed)
    bst = Booster(model_str=text)
    rng = np.random.RandomState(seed + 1)
    sizes = (1, 37, 256, 1000, 4096, 10000)
    reqs = {n: request_rows(rng, n) for n in sizes}
    repeats = {1: 30, 37: 30, 256: 30, 1000: 20, 4096: 20, 10000: 10}

    def counters():
        return {"serve": kernel_module.SERVE_LAUNCHES,
                "traverse": kernel_module.TRAVERSE_LAUNCHES,
                "accumulate": predict_module.ACCUMULATE_LAUNCHES,
                "xla_link": xla_math.LINK_LAUNCHES}

    def zero():
        kernel_module.SERVE_LAUNCHES = 0
        kernel_module.TRAVERSE_LAUNCHES = 0
        predict_module.ACCUMULATE_LAUNCHES = 0
        xla_math.LINK_LAUNCHES = 0

    # ---- the main path, alone between the counter reads
    zero()
    t0 = time.perf_counter()
    rt = ServingRuntime(bst)
    setup_s = time.perf_counter() - t0
    answers, conv, lat = {}, {}, {}
    for n in sizes:
        answers[n] = rt.predict(reqs[n], raw_score=True)
        conv[n] = rt.predict(reqs[n])
        times = []
        for _ in range(repeats[n]):
            torch.cuda.synchronize()
            t = time.perf_counter()
            rt.predict(reqs[n])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        lat[n] = float(np.median(times)) * 1e3
    launches = counters()
    _check(launches["serve"] > 0 and launches["xla_link"] > 0,
           f"main path did not launch every kernel: {launches}")
    _check(launches["traverse"] == 0 and launches["accumulate"] == 0,
           f"main path launched a standalone kernel: {launches}")
    per_request = {}
    for n in (1, 4096, 10000):
        zero()
        rt.predict(reqs[n], raw_score=True)
        raw_l = counters()
        zero()
        rt.predict(reqs[n])
        per_request[str(n)] = {"raw": raw_l, "converted": counters()}
    chunks = -(-10000 // rt.max_batch_rows)
    _check(per_request["4096"]["converted"] == {
        "serve": 1, "traverse": 0, "accumulate": 0, "xla_link": 1}
           and per_request["10000"]["raw"]["serve"] == chunks,
           f"main: launches a request {per_request}")

    # ---- answers against the plain versions on the card and the host
    st = rt._state
    ex = st.export
    obj = bst.objective_
    cpu_rt = ServingRuntime(bst, device="cpu")
    link_err = 0.0
    for n in sizes:
        X = reqs[n]
        want, want_f = [], []
        for lo in range(0, n, rt.max_batch_rows):
            Xc = X[lo:lo + rt.max_batch_rows]
            Xd = rt._stage32(Xc, rt._chunk_rows(Xc.shape[0]))
            want.append(_plain_predict(rt, Xd)[1][:Xc.shape[0]]
                        .cpu().numpy())
            want_f.append(_serve(rt, Xd, plain=True)[:Xc.shape[0]]
                          .cpu().numpy())
        want = np.concatenate(want)
        _check(_bits_equal(answers[n], want),
               f"main: {n} rows: raw scores != plain versions")
        _check(_bits_equal(answers[n], np.concatenate(want_f)),
               f"main: {n} rows: raw scores != the fused plain version")
        _check(bool(np.all(np.isfinite(conv[n]))
                    and np.all((conv[n] > 0) & (conv[n] < 1))),
               f"main: {n} rows: converted scores not finite in (0, 1)")
        # the link: the kernel's answers against its plain version on
        # the same raw scores, on the card and on the CPU
        raw = obj.sigmoid * torch.from_numpy(answers[n]).float()
        for where, plain in (
                ("card", xla_math.xla_sigmoid_plain(raw.cuda()).cpu()),
                ("CPU", xla_math.xla_sigmoid_plain(raw))):
            link_err = max(link_err, _max_abs_err(conv[n], plain.numpy()))
            _check(_bits_equal(conv[n], plain.numpy()),
                   f"main: {n} rows: converted scores != the link's plain "
                   f"version on the {where}")
        _check(_bits_equal(conv[n], cpu_rt.predict(reqs[n])),
               f"main: {n} rows: converted scores != the CPU runtime")
    host = bst.predict(reqs[1000], raw_score=True)
    _check(_bits_equal(answers[1000], host),
           "main: raw scores != f64 host walk on 1000 rows")

    # ---- the kernels at 1, 256 and 4096 rows: parity, times, bounds
    from lightgbm_tpu_torch.compiler.kernel import (traverse_bucket,
                                                    traverse_bucket_plain)
    from lightgbm_tpu_torch.ops.predict import (
        accumulate_slots_exact, accumulate_slots_exact_plain)
    flush = _flusher(rt.device)
    n_trees, nl = ex["leaf_values"].shape
    depth = _leaf_depths(ex["trees"], nl)
    plane_bytes = sum(int(a.numel() * a.element_size())
                      for pl in st.planes for a in pl if a is not None)
    rec_bytes = st.records.nbytes()
    value_bytes = n_trees * nl * 8
    timed = {}
    for b in TIMED_ROWS:
        Xd = rt._stage32(reqs[4096][:b], b)
        slots_k = torch.cat(_traverse(rt, Xd, traverse_bucket))
        slots_p, acc_p = _plain_predict(rt, Xd)
        _check(torch.equal(slots_k, slots_p),
               f"main: {b} rows: kernel slots != plain")
        acc_k = accumulate_slots_exact(slots_k, st.gidx, ex["value_f64"], 1,
                                       None)
        _check(_bits_equal(acc_k.cpu().numpy(), acc_p.cpu().numpy()),
               f"main: {b} rows: kernel accumulation != plain")
        fused = _serve(rt, Xd)
        fused_p = _serve(rt, Xd, plain=True)
        want_b = acc_p.cpu().numpy()
        _check(_bits_equal(fused.cpu().numpy(), fused_p.cpu().numpy())
               and _bits_equal(fused.cpu().numpy(), acc_p.cpu().numpy()),
               f"main: {b} rows: fused kernel != plain")
        row = {"plan": _forest_plan(rt, Xd)._asdict()}
        fns = {
            "serve": lambda: _serve(rt, Xd),
            "traverse": lambda: _traverse(rt, Xd, traverse_bucket),
            "accumulate": lambda: accumulate_slots_exact(
                slots_k, st.gidx, ex["value_f64"], 1, None),
            "unfused": lambda: accumulate_slots_exact(
                torch.cat(_traverse(rt, Xd, traverse_bucket)), st.gidx,
                ex["value_f64"], 1, None)}
        for name, fn in fns.items():
            row[name + "_ms"] = _cuda_ms(fn, queued=True)
            row[name + "_cold_ms"] = _cuda_ms(fn, queued=True, flush=flush)
        row["serve_host_paced_ms"] = _cuda_ms(fns["serve"])
        # the fused kernel's launch plans, each bitwise, then timed
        vplans = {}
        for c, r, i, nt, s in FUSED_SWEEP:
            if r > b:
                continue
            plan = _forest_plan(rt, Xd, cluster=c, rows=r, ilp=i, threads=nt,
                                stage=s)
            key = (f"c{plan.cluster}_r{plan.rows}_i{plan.ilp}_"
                   f"t{plan.threads}{'_staged' if plan.stage else ''}")
            if key not in vplans:
                vplans[key] = plan
                _check(_bits_equal(_serve(rt, Xd, plan=plan).cpu().numpy(),
                                   want_b),
                       f"main: {b} rows: fused kernel {key} != plain")
        vt = {k: _cuda_ms(lambda: _serve(rt, Xd, plan=p), queued=True)
              for k, p in vplans.items()}
        row["variants_ms"] = dict(sorted(vt.items(), key=lambda kv: kv[1]))
        # bounds from this run's inputs
        gathered = slots_k[st.gidx.long()].cpu().numpy()
        visits = int(np.take_along_axis(depth, gathered, axis=1).sum())
        row["node_visits"] = visits
        # the sectors the fused walks read
        row["serve_bytes"], serve_visits = _serve_bytes(
            Xd, st.records, ex["value_f64"])
        want_visits = _record_visits(ex, slots_k[st.gidx.long()])
        _check(serve_visits == want_visits,
               f"main: {b} rows: the records' walk visits {serve_visits} "
               f"nodes, the slots' depths {want_visits}")
        row["serve_bound_ms"], row["serve_bound_by"] = _bound(
            row["serve_bytes"], visits, INT32_OPS_PER_S)
        row["traverse_bytes"] = (Xd.numel() * 4 + plane_bytes
                                 + int(slots_k.shape[0]) * b * 4)
        row["traverse_bound_ms"], row["traverse_bound_by"] = _bound(
            row["traverse_bytes"], visits, INT32_OPS_PER_S)
        row["accumulate_bytes"] = (n_trees * b * 4 + n_trees * 4
                                   + value_bytes + b * 8)
        row["accumulate_bound_ms"], row["accumulate_bound_by"] = _bound(
            row["accumulate_bytes"], n_trees * b, F64_ADDS_PER_S)
        if b == 4096:
            row["serve_plain_ms"] = _cuda_ms(
                lambda: _serve(rt, Xd, plain=True), iters=3, warmup=1)
            row["traverse_plain_ms"] = _cuda_ms(
                lambda: _traverse(rt, Xd, traverse_bucket_plain), iters=3,
                warmup=1)
            row["accumulate_plain_ms"] = _cuda_ms(
                lambda: accumulate_slots_exact_plain(
                    slots_k, st.gidx, ex["value_f64"], 1, None), iters=3,
                warmup=1)
            errs = (int((slots_k - slots_p).abs().max()),
                    _max_abs_err(acc_k.cpu().numpy(), acc_p.cpu().numpy()),
                    _max_abs_err(fused.cpu().numpy(), fused_p.cpu().numpy()))
        timed[b] = row
    breakdown = _request_breakdown(rt, reqs[4096])
    tree_depths = [int(depth[i].max()) for i in range(n_trees)]
    big = timed[4096]
    _emit({"phase": "main", "seed": seed, "trees": n_trees,
           "num_leaves": nl, "features": int(reqs[1].shape[1]),
           "max_depth": max(tree_depths),
           "mean_leaf_depth_4096": big["node_visits"] / (n_trees * 4096),
           "depth_buckets": {str(bk.depth): sum(len(t) for t in bk.tiles)
                             for bk in st.plan.buckets},
           "tiles": st.plan.num_tiles(), "record_bytes": rec_bytes,
           "tile_kb": rt._tile_vmem_kb, "setup_s": setup_s,
           "p50_ms": {str(n): lat[n] for n in sizes},
           "rows_per_s_4096": 4096 / (lat[4096] / 1e3),
           "kernels_by_rows": {str(b): timed[b] for b in TIMED_ROWS},
           "request_4096": breakdown, "node_visits_4096": big["node_visits"],
           "library_ms": None, "launches": launches,
           "launches_per_request": per_request})

    def by_rows(key):
        return {str(b): timed[b][key] for b in TIMED_ROWS}

    def entry(name, source, replaces, key, err):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[key],
                "max_abs_err": err, "ms": big[key + "_ms"],
                "plain_ms": big[key + "_plain_ms"],
                "bound_ms": big[key + "_bound_ms"],
                "bound_by": big[key + "_bound_by"], "library_ms": None,
                "rows": 4096, "ms_by_rows": by_rows(key + "_ms"),
                "cold_ms_by_rows": by_rows(key + "_cold_ms"),
                "bound_ms_by_rows": by_rows(key + "_bound_ms")}

    return [
        entry("serve_forest", "lightgbm_tpu_torch/csrc/serve.cu",
              "lightgbm_tpu/compiler/kernel.py:60", "serve", errs[2]),
        entry("traverse", "lightgbm_tpu_torch/csrc/traverse.cu",
              "lightgbm_tpu/compiler/kernel.py:60", "traverse", errs[0]),
        entry("accumulate_exact", "lightgbm_tpu_torch/csrc/accumulate.cu",
              "lightgbm_tpu/ops/predict.py:501", "accumulate", errs[1]),
    ], launches["xla_link"], link_err

# ------------------------------------------------------------ training
#: the train phase's problem: the shape of the repo's own bench
#: (`bench.py` workload: 28 features, 2M training rows, up to 200k held
#: out) and of upstream LightGBM's Higgs experiment (num_leaves 255)
TRAIN_ROWS = 2_000_000
HOLD_ROWS = 200_000
TRAIN_FEATURES = 28
TRAIN_ROUNDS = 10
TRAIN_PARAMS = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
                "learning_rate": 0.1, "verbosity": -1}


def make_higgs_like(n: int, f: int, seed: int):
    """A Higgs-shaped binary problem: the generator of the JAX package's
    bench (`bench.py` `_make_higgs_like`), copied so this script imports
    nothing of that package.  f32 features, f64 0/1 labels."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    score = (1.2 * X[:, 0] - 0.8 * X[:, 1] + X[:, 2] * X[:, 3]
             + 0.5 * np.sin(3 * X[:, 4]) + 0.6 * X[:, 5] ** 2
             - 0.4 * np.abs(X[:, 6]))
    y = (score + rng.randn(n) * 1.0 > 0).astype(np.float64)
    return X, y


class _CallTimer:
    """Within it, the calls of `owner.name` are timed: their total
    seconds, count, and the first start and last end (perf_counter)."""

    def __init__(self, owner, name, sync=False):
        self.owner, self.name, self.sync = owner, name, sync
        self.s, self.calls, self.first, self.last = 0.0, 0, None, None

    def __enter__(self):
        self.raw = self.owner.__dict__[self.name] \
            if isinstance(self.owner, type) else getattr(self.owner,
                                                         self.name)
        static = isinstance(self.raw, staticmethod)
        fn = self.raw.__func__ if static else self.raw

        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if self.sync:
                import torch
                torch.cuda.synchronize()
            t1 = time.perf_counter()
            self.s += t1 - t0
            self.calls += 1
            self.first = t0 if self.first is None else self.first
            self.last = t1
            return out

        setattr(self.owner, self.name, staticmethod(timed) if static
                else timed)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.raw)
        return False


class TrainData:
    """The train phase's data, binned once on the host and shared with
    the histogram phase (its bins are K1's inputs at the root shape)."""

    def __init__(self, seed: int, n_train: int = TRAIN_ROWS,
                 n_hold: int = HOLD_ROWS, f: int = TRAIN_FEATURES):
        import lightgbm_tpu_torch as lt
        from lightgbm_tpu_torch.basic import Dataset
        X, y = make_higgs_like(n_train + n_hold, f, seed)
        self.X, self.y = X[:n_train], y[:n_train]
        self.X_hold, self.y_hold = X[n_train:], y[n_train:]
        t0 = time.perf_counter()
        # the raw rows stay with the dataset (they are held here anyway):
        # continued training predicts the init model on them.  The greedy
        # bin search and the value-to-bin pass are timed apart
        with _CallTimer(Dataset, "_fit_bin_mappers") as search, \
                _CallTimer(Dataset, "_apply_bins") as pass_:
            self.dataset = lt.Dataset(self.X, label=self.y,
                                      params=dict(TRAIN_PARAMS),
                                      free_raw_data=False).construct()
        self.binning_s = time.perf_counter() - t0
        self.search_s, self.pass_s = search.s, pass_.s


def _hist_inputs(bins_np, y, leaf_frac, slots, seed, device):
    """K1 inputs on `device`: bins [F, N], the first round's binary
    payload (g = p - y, h = p (1 - p) at p = mean(y), w = 1), leaf ids
    with `leaf_frac` of the rows in leaf 0 (else leaves 1..11), and
    `slots`."""
    import torch
    rng = np.random.RandomState(seed)
    n = bins_np.shape[1]
    p = np.float32(y.mean())
    payload = np.stack([p - y.astype(np.float32),
                        np.full(n, p * (1 - p), np.float32),
                        np.ones(n, np.float32)], axis=1)
    if leaf_frac >= 1.0:
        leaf = np.zeros(n, np.int32)
    elif leaf_frac > 0:
        leaf = np.where(rng.rand(n) < leaf_frac, 0,
                        rng.randint(1, 12, n)).astype(np.int32)
    else:
        leaf = rng.randint(0, 12, n).astype(np.int32)
    return (torch.from_numpy(np.ascontiguousarray(bins_np)).to(device),
            torch.from_numpy(payload).to(device),
            torch.from_numpy(leaf).to(device),
            torch.tensor(slots, dtype=torch.int32, device=device))


def _f64_histogram(bins, pay, mb):
    """The root histogram summed in f64: the yardstick both the kernel
    and the plain version are measured against."""
    import torch
    f, n = bins.shape
    flat = (bins.to(torch.int64) + torch.arange(
        f, device=bins.device)[:, None] * mb).reshape(-1)
    out = torch.zeros((f * mb, 3), dtype=torch.float64, device=bins.device)
    out.index_add_(0, flat, pay.double().repeat(f, 1))
    return out.reshape(f, mb, 3)


def _hist_bytes(bins, rows_in, s, mb):
    """Bytes K1 must move for these inputs: the leaf id of every row (the
    kernel cannot know which rows are in the slots without reading it),
    the bins and payload of the `rows_in` rows in the slots, the [S, F,
    MB, 3] f32 histogram out."""
    f, n = bins.shape
    return (n * 4 + rows_in * (f * bins.element_size() + 12)
            + s * f * mb * 3 * 4)


#: histogram cases where K1 is held bitwise to `histogram_multi_ordered`
ORDERED_CASES = ("leaf_1pct", "u16_1023")


def phase_histogram(data: TrainData, seed: int, device=None,
                    u16_rows: int = 100_000, timing: bool = True):
    """K1 against its plain version on the card, then timed at the root
    shape.  Returns the kernels-line entry (launches filled in by the
    train phase)."""
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops.hist_kernel import (
        histogram_multi, histogram_multi_ordered, histogram_multi_plain)
    dev = torch.device(device or "cuda")
    ds = data.dataset
    bins_fm = ds.bin_data.T
    mb = max(m.num_bin for m in ds.bin_mappers)
    Xw = data.X[:u16_rows]
    wide = lt.Dataset(Xw, label=data.y[:u16_rows],
                      params={"max_bin": 1023, "verbosity": -1}).construct()
    _check(wide.bin_data.dtype == np.uint16, "u16 case is not uint16")
    mb_w = max(m.num_bin for m in wide.bin_mappers)
    cases = [("root", bins_fm, data.y, 1.0, [0], mb),
             ("leaf_1pct", bins_fm, data.y, 0.01, [0], mb),
             ("slots_14", bins_fm, data.y, 0.0,
              list(range(12)) + [300, 301], mb),
             ("u16_1023", wide.bin_data.T, data.y[:u16_rows], 1.0, [0],
              mb_w)]
    report = {"phase": "histogram", "cases": {}}
    worst = 0.0
    inputs = {}
    for name, bnp, y, frac, slots, m in cases:
        bins, pay, lid, sl = _hist_inputs(bnp, y, frac, slots, seed, dev)
        inputs[name] = (bins, pay, lid, sl, m)
        k1 = histogram_multi(bins, pay, lid, sl, m)
        k2 = histogram_multi(bins, pay, lid, sl, m)
        plain = histogram_multi_plain(bins, pay, lid, sl, m)
        absum = histogram_multi_plain(bins, pay.abs(), lid, sl, m)
        err = (k1 - plain).abs()
        within = bool((err <= 1e-4 * absum + 1e-6).all())
        counts = bool(torch.equal(k1[..., 2], plain[..., 2]))
        repro = bool(torch.equal(k1, k2))
        pads = [i for i, s_ in enumerate(slots) if s_ >= 12]
        pad_zero = all(not bool(k1[i].any()) for i in pads)
        _check(within, f"histogram {name}: kernel outside 1e-4*sum|x|+1e-6")
        _check(counts, f"histogram {name}: counts differ from plain")
        _check(repro, f"histogram {name}: two launches differ")
        _check(pad_zero, f"histogram {name}: a pad slot is not zero")
        worst = max(worst, float(err.max()))
        if name in ORDERED_CASES:
            # the kernel adds in the order hist_common.cuh documents; the
            # CPU model adds in that order too (the plain version on the
            # CPU adds in row order, so this gates only on the card)
            ordered = histogram_multi_ordered(bins.cpu(), pay.cpu(),
                                              lid.cpu(), sl.cpu(), m)
            same = _bits_equal(k1.cpu().numpy(), ordered.numpy())
            _check(same or dev.type != "cuda",
                   f"histogram {name}: kernel != histogram_multi_ordered")
        rows_in = int((lid[:, None] == sl[None, :]).any(1).sum())
        nbytes = _hist_bytes(bins, rows_in, len(slots), m)
        adds = 3 * rows_in * int(bins.shape[0])
        report["cases"][name] = {
            "rows": int(bins.shape[1]), "features": int(bins.shape[0]),
            "slots": len(slots), "max_bin": int(m),
            "dtype": str(bnp.dtype), "rows_in_slots": rows_in,
            "within_tol": within, "counts_exact": counts,
            "bitwise_repro": repro, "max_abs_err": float(err.max()),
            "bitwise_ordered": (same if name in ORDERED_CASES else None),
            "bytes": nbytes, "adds": adds,
            "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                            adds / F32_OPS_PER_S) * 1e3}

    bins, pay, lid, sl, m = inputs["root"]
    f, n = bins.shape
    exact = _f64_histogram(bins, pay, m)[None]
    err64 = {"kernel": float((histogram_multi(bins, pay, lid, sl, m)
                              .double() - exact).abs().max()),
             "plain": float((histogram_multi_plain(bins, pay, lid, sl, m)
                             .double() - exact).abs().max())}
    flat_idx = (bins.to(torch.int64)
                + torch.arange(f, device=dev)[:, None] * m).reshape(-1)
    src = pay.repeat(f, 1)

    def library():
        return torch.zeros((f * m, 3), device=dev).index_add_(0, flat_idx,
                                                              src)
    lib_err = float((library().reshape(f, m, 3)
                     - histogram_multi(bins, pay, lid, sl, m)[0]).abs().max())
    timed = {}
    if timing:
        timed = {
            "ms": _cuda_ms(lambda: histogram_multi(bins, pay, lid, sl, m)),
            "plain_ms": _cuda_ms(lambda: histogram_multi_plain(
                bins, pay, lid, sl, m), iters=5, warmup=1),
            "library_ms": _cuda_ms(library, iters=5, warmup=1)}
        for name, (b2, p2, l2, s2, m2) in inputs.items():
            report["cases"][name]["ms"] = _cuda_ms(
                lambda: histogram_multi(b2, p2, l2, s2, m2))
            report["cases"][name]["device_ms"] = _cuda_ms(
                lambda: histogram_multi(b2, p2, l2, s2, m2), queued=True)
    nbytes = report["cases"]["root"]["bytes"]
    adds = report["cases"]["root"]["adds"]
    bound_ms = report["cases"]["root"]["bound_ms"]
    report.update({"root_max_abs_err_vs_f64": err64,
                   "root_bytes": nbytes, "root_adds": adds,
                   "bound_ms": bound_ms, "library_max_abs_diff": lib_err,
                   **timed})
    _emit(report)
    return {"name": "histogram", "route": "cuda",
            "source": "lightgbm_tpu_torch/csrc/histogram.cu",
            "replaces": "lightgbm_tpu/ops/pallas_hist.py:85",
            "launches": 0, "max_abs_err": worst,
            "ms": timed.get("ms"), "plain_ms": timed.get("plain_ms"),
            "bound_ms": bound_ms,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
            >= adds / F32_OPS_PER_S else "operations",
            "library_ms": timed.get("library_ms")}


def _auc(score, label):
    from lightgbm_tpu_torch.metrics import _auc as auc
    return auc(np.asarray(score, np.float64), np.asarray(label, np.float64),
               None, None)


def f32_threshold_walk(bst, X):
    """Raw scores of the f64 host walk over `bst` with every numerical
    threshold rounded to f32, the routing the serving path compiles (the
    JAX package's compiled rung keeps round-to-nearest f32 thresholds):
    for f32-representable rows it decides every node as the card does.
    It differs from the walk at the model's own f64 thresholds only for
    a row whose value lies between a threshold and its f32 rounding."""
    import copy
    b32 = copy.copy(bst)
    b32.trees = []
    for t in bst.trees:
        t2 = copy.copy(t)
        t2.threshold = t.threshold.astype(np.float32).astype(np.float64)
        b32.trees.append(t2)
    return b32.predict(X, raw_score=True)


def _profile_round(params, dataset):
    """One more training round under `torch.profiler`: the wall time,
    the device time summed over its kernels, the number of kernel
    launches, and the kernels that took most device time.  The device
    time is None when the profiler recorded no kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    import lightgbm_tpu_torch as lt
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        lt.train(params, dataset, num_boost_round=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    busy = sum(by_name.values())
    # the port's own kernels (the __global__ functions of csrc/): device
    # ms and launches, whatever the host's pace
    csrc = os.path.join(ROOT, "lightgbm_tpu_torch", "csrc")
    names = set()
    for fname in os.listdir(csrc):
        if fname.endswith((".cu", ".cuh")):
            with open(os.path.join(csrc, fname)) as fh:
                names.update(re.findall(
                    r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                    r"(\w+)\s*\(", fh.read()))
    ours = {}
    for e in kernels:
        head, _, key = e.name.partition("(anonymous namespace)::")
        key = key.split("<")[0].split("(")[0]
        if head in ("", "void ") and key in names:
            ms, count = ours.get(key, (0.0, 0))
            ours[key] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    return {"wall_ms": wall * 1e3,
            "kernel_ms": busy / 1e3 if kernels else None,
            "kernels": len(kernels),
            "top_kernels_ms": [(n[:60], us / 1e3) for n, us in top],
            "port_kernels_ms_launches": ours}


def phase_train(data: TrainData, modules, device=None, timing=True):
    """`lightgbm_tpu_torch.train` at full width, three times: two
    kernel-trained runs (the first one timed) and one with
    hist_impl=segment_sum; then the first model served on the card.
    Returns the launch counts of this phase."""
    import torch
    import lightgbm_tpu_torch as lt
    import lightgbm_tpu_torch.ops.grow as grow_module
    hist_module = modules["hist"]
    params = dict(TRAIN_PARAMS)
    if device is not None:
        params["device_type"] = device

    # ---- the main path, alone between the counter reads: train, serve
    hist_module.HIST_LAUNCHES = 0
    modules["kernel"].SERVE_LAUNCHES = 0
    modules["kernel"].TRAVERSE_LAUNCHES = 0
    modules["predict"].ACCUMULATE_LAUNCHES = 0
    grow_module.HOST_SYNCS = 0
    real_hist = grow_module.histogram_multi
    events = []              # (round, start, end) CUDA events per K1 call
    marks = []               # host clock after each round, synchronised
    rounds_done = [0]

    def timed_hist(*a):
        if not timing:
            return real_hist(*a)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real_hist(*a)
        end.record()
        events.append((rounds_done[0], start, end))
        return out

    def mark_round(env):
        if timing:
            torch.cuda.synchronize()
        marks.append(time.perf_counter())
        rounds_done[0] += 1

    grow_module.histogram_multi = timed_hist
    try:
        t0 = time.perf_counter()
        bst = lt.train(params, data.dataset, num_boost_round=TRAIN_ROUNDS,
                       callbacks=[mark_round])
        train_s = time.perf_counter() - t0
    finally:
        grow_module.histogram_multi = real_hist
    syncs = grow_module.HOST_SYNCS
    rt = lt.ServingRuntime(bst, device=device)
    raw_card = rt.predict(data.X_hold, raw_score=True)
    launches = {"histogram": hist_module.HIST_LAUNCHES,
                "serve": modules["kernel"].SERVE_LAUNCHES,
                "traverse": modules["kernel"].TRAVERSE_LAUNCHES,
                "accumulate": modules["predict"].ACCUMULATE_LAUNCHES}
    splits = sum(t.num_leaves - 1 for t in bst.trees)
    _check(launches["histogram"] >= TRAIN_ROUNDS + splits,
           f"train: {launches['histogram']} K1 launches for "
           f"{len(bst.trees)} trees with {splits} splits")
    _check(launches["serve"] > 0 and launches["traverse"] == 0
           and launches["accumulate"] == 0,
           f"train: serving the trained model launched {launches}")

    # ---- gates
    raw_host = bst.predict(data.X_hold, raw_score=True)
    raw_host32 = f32_threshold_walk(bst, data.X_hold)
    _check(_bits_equal(raw_card, raw_host32),
           "train: served scores != host walk at f32 thresholds")
    gap_rows = int(np.sum(raw_card != raw_host))
    text = bst.model_to_string()
    again = lt.train(params, data.dataset, num_boost_round=TRAIN_ROUNDS)
    _check(again.model_to_string() == text,
           "train: two kernel-trained runs differ")
    seg = lt.train(dict(params, hist_impl="segment_sum"), data.dataset,
                   num_boost_round=TRAIN_ROUNDS)
    auc_k = _auc(raw_host, data.y_hold)
    auc_s = _auc(seg.predict(data.X_hold, raw_score=True), data.y_hold)
    _check(abs(auc_k - auc_s) <= 1e-3,
           f"train: held-out AUC {auc_k} vs segment_sum {auc_s}")
    same = sum(
        a.num_leaves == b.num_leaves
        and all(np.array_equal(getattr(a, k), getattr(b, k))
                for k in ("split_feature", "threshold_bin", "left_child",
                          "right_child"))
        for a, b in zip(bst.trees, seg.trees))
    _check(bool(np.all(np.isfinite(raw_host))) and
           len(bst.trees) == TRAIN_ROUNDS, "train: bad model")

    report = {"phase": "train", "rows": int(data.X.shape[0]),
              "held_out": int(data.X_hold.shape[0]),
              "features": int(data.X.shape[1]), "rounds": TRAIN_ROUNDS,
              "params": TRAIN_PARAMS, "binning_s": data.binning_s,
              "trees": len(bst.trees), "splits": splits,
              "leaves_per_tree": [t.num_leaves for t in bst.trees],
              "auc_kernel": auc_k, "auc_segment_sum": auc_s,
              "trees_equal_to_segment_sum": int(same),
              "model_text_identical": True,
              "served_bitwise_f32_threshold_walk": True,
              "served_rows_differing_from_f64_walk": gap_rows,
              "host_syncs": syncs,
              "host_syncs_per_tree": syncs / len(bst.trees),
              "train_s": train_s, "launches": launches}
    if timing:
        report["profiled_round"] = _profile_round(params, data.dataset)
        round_s = np.diff([t0] + marks)
        k1_ms = np.zeros(TRAIN_ROUNDS)
        for r, start, end in events:
            k1_ms[r] += start.elapsed_time(end)
        steady = round_s[1:]
        report.update({
            "round_ms": [float(x) * 1e3 for x in round_s],
            "ms_per_round_2_to_10": float(steady.mean()) * 1e3,
            "rounds_per_s_2_to_10": float(1.0 / steady.mean()),
            "k1_ms_per_round": [float(x) for x in k1_ms],
            "k1_share_2_to_10": float(k1_ms[1:].sum()
                                      / (steady.sum() * 1e3)),
            "k1_calls": len(events)})
    _emit(report)
    return launches


# ------------------------------------------------------------- the wave
#: the wave phase's configuration: the repo's own bench configuration
#: (`bench.py` BENCH_CONFIG from `benchmarks/configs_r4.py` SHIPPED =
#: "wave_w8_tail16": wave policy, width 8, gain ratio 0, strict tail 16;
#: num_leaves 31, f32 histograms) on the train phase's data
WAVE_PARAMS = dict(TRAIN_PARAMS, num_leaves=31, tree_grow_policy="wave",
                   tpu_wave_width=8, tpu_wave_gain_ratio=0,
                   tpu_wave_strict_tail=16)
#: the wide wave run: K2 at the full 14-slot chunk on the training path
WAVE_WIDE = dict(WAVE_PARAMS, num_leaves=255, tpu_wave_width=14)
#: the kernel phase's split-scan settings (l1 and the gates non-trivial)
FUSED_SCAN_KW = dict(l1=0.5, l2=1.0, min_data_in_leaf=20.0,
                     min_sum_hessian=1e-3, min_gain_to_split=0.01)
#: operations of the scan per (slot, feature, bin): 3 prefix adds, then
#: per case 3 adds of the NaN bin's sums, 3 subtractions for the right
#: side, two leaf gains of 7 operations, 2 adds and 4 gate compares
SCAN_OPS_PER_BIN = 3 + 2 * (3 + 3 + 14 + 2 + 4)


def _partition(bins_np, levels: int):
    """Leaf ids of a real partition of the rows: `levels` depth-wise
    splits at the median bin of features 0, 1, 2, ... (2^levels leaves)."""
    lid = np.zeros(bins_np.shape[1], np.int32)
    for k in range(levels):
        col = bins_np[k]
        lid += (col > np.median(col)).astype(np.int32) << k
    return lid


def _wave_payload(y, seed):
    """A binary payload with per-row hessians: g = p - y, h = p (1 - p),
    w = 1, p drawn from [0.2, 0.8]."""
    rng = np.random.RandomState(seed)
    p = rng.uniform(0.2, 0.8, len(y)).astype(np.float32)
    return np.stack([p - y.astype(np.float32), p * (1 - p),
                     np.ones(len(y), np.float32)], axis=1)


def _without(text, *keys):
    """Model text without the parameter lines of `keys` (the runs a gate
    compares differ only in those settings)."""
    return "\n".join(ln for ln in text.splitlines()
                     if not any(ln.startswith(f"[{k}:") for k in keys))


def _fields_equal(a, b):
    """Two SplitResults equal field for field, bitwise (a numerical
    search leaves the categorical fields None on both)."""
    import torch
    return all((x is None and y_ is None)
               or (x is not None and y_ is not None
                   and x.dtype == y_.dtype and torch.equal(x, y_)
                   and bool(torch.equal(torch.signbit(x.float()),
                                        torch.signbit(y_.float()))))
               for x, y_ in zip(a, b))


def _hist14(fn, bins, pay, lid, sl, mb):
    """`fn` (K1's `histogram_multi` or its plain version, at most 14
    slots a call) over any number of slots, 14 at a time."""
    import torch
    return torch.cat([fn(bins, pay, lid, sl[c:c + 14], mb)
                      for c in range(0, sl.shape[0], 14)])


def phase_fused(data: TrainData, seed: int, device=None,
                u16_rows: int = 100_000, timing: bool = True):
    """K2 and K3 on the card against K1 and the plain scan, on the train
    phase's bins: S = 1 at the root and on one leaf of a depth-5
    partition, S = 8 and S = 14 over a real
    partition of the rows with one slot that matches no row, S = 42
    over a depth-6 partition (K2 in three launches, K3 in one), and u16
    bins at max_bin 1023.  Returns the kernels-line entries of K2 and K3
    at the S = 8 case (the bench's wave width; launches filled in by the
    wave phase)."""
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import fused_kernel as fk
    from lightgbm_tpu_torch.ops.hist_kernel import (histogram_multi,
                                                    histogram_multi_plain)
    from lightgbm_tpu_torch.ops.split import (decide_from_candidates,
                                              find_best_split)
    dev = torch.device(device or "cuda")
    ds = data.dataset
    wide = lt.Dataset(data.X[:u16_rows], label=data.y[:u16_rows],
                      params={"max_bin": 1023, "verbosity": -1}).construct()
    _check(wide.bin_data.dtype == np.uint16, "u16 case is not uint16")
    bins_main = np.ascontiguousarray(ds.bin_data.T)
    bins_wide = np.ascontiguousarray(wide.bin_data.T)
    lid3 = _partition(bins_main, 3)
    lid4 = _partition(bins_main, 4)
    cases = [("root_s1", ds, bins_main, data.y, np.zeros_like(lid3), [0]),
             ("leaf_s1", ds, bins_main, data.y, _partition(bins_main, 5),
              [0]),
             ("s8", ds, bins_main, data.y, lid3, list(range(7)) + [99]),
             ("s14", ds, bins_main, data.y, lid4, list(range(13)) + [99]),
             ("s42", ds, bins_main, data.y, _partition(bins_main, 6),
              list(range(42))),
             ("u16_1023_s4", wide, bins_wide, data.y[:u16_rows],
              _partition(bins_wide, 2), [0, 1, 2, 3])]
    report = {"phase": "fused", "scan_kw": FUSED_SCAN_KW, "cases": {}}
    kw = FUSED_SCAN_KW
    entries = {}
    worst = {"k2": 0.0, "k3": 0.0}
    for name, d, bnp, y, lid_np, slots in cases:
        mb = max(m.num_bin for m in d.bin_mappers)
        f, n = bnp.shape
        # the real bin counts and default bins; missing types cycled
        # through None, Zero and NaN so that both cases of the scan run
        nb = torch.tensor([m.num_bin for m in d.bin_mappers],
                          dtype=torch.int32, device=dev)
        miss = torch.arange(f, dtype=torch.int32, device=dev) % 3
        dflt = torch.tensor([m.default_bin for m in d.bin_mappers],
                            dtype=torch.int32, device=dev)
        bins = torch.from_numpy(bnp).to(dev)
        pay = torch.from_numpy(_wave_payload(y, seed)).to(dev)
        lid = torch.from_numpy(lid_np).to(dev)
        sl = torch.tensor(slots, dtype=torch.int32, device=dev)
        k1 = _hist14(histogram_multi, bins, pay, lid, sl, mb)
        parent = k1[:, 0].sum(dim=1).contiguous()            # [S, 3]
        h2, c2 = fk.fused_hist_split(bins, pay, lid, sl, nb, miss, parent,
                                     mb, **kw)
        h2b, c2b = fk.fused_hist_split(bins, pay, lid, sl, nb, miss, parent,
                                       mb, **kw)
        c3 = fk.split_scan(h2, nb, miss, parent, **kw)
        c3b = fk.split_scan(h2, nb, miss, parent, **kw)
        plain = fk.split_scan_plain(h2, nb, miss, parent, **kw)
        # K2 against its own plain version on the same inputs, by K1's
        # rule (K1 shares K2's first stage, so bitwise K1 alone would
        # not catch a fault in that shared code)
        hp = _hist14(histogram_multi_plain, bins, pay, lid, sl, mb)
        absum = _hist14(histogram_multi_plain, bins, pay.abs(), lid, sl,
                        mb)
        k2_err = (h2 - hp).abs()
        _check(bool((k2_err <= 1e-4 * absum + 1e-6).all()),
               f"fused {name}: K2's histogram outside 1e-4*sum|x|+1e-6 "
               "of the plain version")
        _check(torch.equal(h2[..., 2], hp[..., 2]),
               f"fused {name}: K2's counts differ from the plain version")
        _check(torch.equal(h2, k1) and _bits_equal(h2.cpu().numpy(),
                                                   k1.cpu().numpy()),
               f"fused {name}: K2's histogram != K1's")
        _check(_bits_equal(c2.cpu().numpy(), plain.cpu().numpy()),
               f"fused {name}: K2's candidates != the plain scan")
        _check(_bits_equal(c3.cpu().numpy(), c2.cpu().numpy()),
               f"fused {name}: K3's candidates != K2's")
        _check(_bits_equal(h2b.cpu().numpy(), h2.cpu().numpy())
               and _bits_equal(c2b.cpu().numpy(), c2.cpu().numpy())
               and _bits_equal(c3b.cpu().numpy(), c3.cpu().numpy()),
               f"fused {name}: two launches differ")
        allowed = torch.ones(f, dtype=torch.bool, device=dev)
        got = decide_from_candidates(c2, parent[:, 0], parent[:, 1],
                                     parent[:, 2], miss, dflt, allowed)
        want = find_best_split(h2, parent[:, 0], parent[:, 1], parent[:, 2],
                               nb, miss, dflt, allowed, kw["l1"], kw["l2"],
                               kw["min_data_in_leaf"], kw["min_sum_hessian"],
                               kw["min_gain_to_split"])
        _check(_fields_equal(got, want),
               f"fused {name}: decide_from_candidates != find_best_split")
        pads = [i for i, s_ in enumerate(slots) if s_ == 99]
        _check(all(not bool(h2[i].any()) for i in pads),
               f"fused {name}: a pad slot's histogram is not zero")
        k2_hist_err = float(k2_err.max())
        k2_cand_err = _max_abs_diff(c2, plain)
        k3_err = _max_abs_diff(c3, plain)
        worst["k2"] = max(worst["k2"], k2_hist_err, k2_cand_err)
        worst["k3"] = max(worst["k3"], k3_err)
        rows_in = int((lid[:, None] == sl[None, :]).any(1).sum())
        s = len(slots)
        k2_bytes = (_hist_bytes(bins, rows_in, s, mb)
                    + s * 2 * f * 32)
        k3_bytes = s * f * mb * 12 + s * 2 * f * 32
        k2_ops = 3 * rows_in * f + s * f * mb * SCAN_OPS_PER_BIN
        k3_ops = s * f * mb * SCAN_OPS_PER_BIN
        case = {"rows": n, "features": f, "slots": s, "max_bin": mb,
                "dtype": str(bnp.dtype), "rows_in_slots": rows_in,
                "splits_found": int((got.feature >= 0).sum()),
                "k2_hist_bitwise_k1": True, "k2_cand_bitwise_plain": True,
                "k3_cand_bitwise_k2": True, "decide_equals_find": True,
                "bitwise_repro": True, "k2_hist_within_tol_plain": True,
                "k2_counts_exact_plain": True,
                "k2_hist_max_abs_err_plain": k2_hist_err,
                "k2_cand_max_abs_err_plain": k2_cand_err,
                "k3_cand_max_abs_err_plain": k3_err,
                "k2_bytes": k2_bytes, "k3_bytes": k3_bytes,
                "k2_bound_ms": max(k2_bytes / HBM_BYTES_PER_S,
                                   k2_ops / F32_OPS_PER_S) * 1e3,
                "k3_bound_ms": max(k3_bytes / HBM_BYTES_PER_S,
                                   k3_ops / F32_OPS_PER_S) * 1e3}
        if timing:
            case.update({
                "k2_ms": _cuda_ms(lambda: fk.fused_hist_split(
                    bins, pay, lid, sl, nb, miss, parent, mb, **kw)),
                "k2_plain_ms": _cuda_ms(lambda: [
                    fk.fused_hist_split_plain(
                        bins, pay, lid, sl[c:c + 14], nb, miss,
                        parent[c:c + 14], mb, **kw)
                    for c in range(0, s, 14)], iters=3, warmup=1),
                "k2_device_ms": _cuda_ms(lambda: fk.fused_hist_split(
                    bins, pay, lid, sl, nb, miss, parent, mb, **kw),
                    queued=True),
                "k1_ms": _cuda_ms(lambda: _hist14(histogram_multi, bins,
                                                  pay, lid, sl, mb)),
                "k3_ms": _cuda_ms(lambda: fk.split_scan(
                    h2, nb, miss, parent, **kw), queued=True),
                "k3_host_pace_ms": _cuda_ms(lambda: fk.split_scan(
                    h2, nb, miss, parent, **kw)),
                "k3_plain_ms": _cuda_ms(lambda: fk.split_scan_plain(
                    h2, nb, miss, parent, **kw), iters=5, warmup=1)})
        report["cases"][name] = case
        if name == "s8":
            # max_abs_err is filled in after the last case
            entries = {
                "fused_hist_split": {
                    "name": "fused_hist_split", "route": "cuda",
                    "source": "lightgbm_tpu_torch/csrc/fused_split.cu",
                    "replaces": "lightgbm_tpu/ops/pallas_hist.py:486",
                    "launches": 0, "ms": case.get("k2_ms"),
                    "plain_ms": case.get("k2_plain_ms"),
                    "bound_ms": case["k2_bound_ms"],
                    "bound_by": "bytes" if k2_bytes / HBM_BYTES_PER_S
                    >= k2_ops / F32_OPS_PER_S else "operations",
                    "library_ms": None},
                "split_scan": {
                    "name": "split_scan", "route": "cuda",
                    "source": "lightgbm_tpu_torch/csrc/fused_split.cu",
                    "replaces": "lightgbm_tpu/ops/pallas_hist.py:775",
                    "launches": 0, "ms": case.get("k3_ms"),
                    "plain_ms": case.get("k3_plain_ms"),
                    "bound_ms": case["k3_bound_ms"],
                    "bound_by": "bytes" if k3_bytes / HBM_BYTES_PER_S
                    >= k3_ops / F32_OPS_PER_S else "operations",
                    "library_ms": None}}
    entries["fused_hist_split"]["max_abs_err"] = worst["k2"]
    entries["split_scan"]["max_abs_err"] = worst["k3"]
    report["max_abs_err"] = worst
    report["library_ms"] = None
    report["library_note"] = ("no single PyTorch call computes a "
                              "histogram together with a split scan, or "
                              "the scan's per-feature first-wins argmax")
    _emit(report)
    return entries


def _wave_counters(modules):
    from lightgbm_tpu_torch.ops import grow as grow_module
    from lightgbm_tpu_torch.ops import grow_wave
    return {"k2": modules["fused"].FUSED_LAUNCHES,
            "k3": modules["fused"].SCAN_LAUNCHES,
            "k1": modules["hist"].HIST_LAUNCHES,
            "syncs": grow_module.HOST_SYNCS, "waves": grow_wave.WAVES,
            "hist_waves": grow_wave.HIST_WAVES}


def _zero_wave_counters(modules):
    from lightgbm_tpu_torch.ops import grow as grow_module
    from lightgbm_tpu_torch.ops import grow_wave
    modules["fused"].FUSED_LAUNCHES = 0
    modules["fused"].SCAN_LAUNCHES = 0
    modules["hist"].HIST_LAUNCHES = 0
    grow_module.HOST_SYNCS = 0
    grow_wave.WAVES = 0
    grow_wave.HIST_WAVES = 0


def _wave_run(params, dataset, modules, rounds, timing, patch=None,
              counters=_wave_counters, **train_kw):
    """One wave training run with per-round `counters`, round marks and,
    with `timing`, CUDA events around every call of the functions
    `patch` names ((module, attribute) pairs; default K2 and K3 as the
    wave grower calls them); `train_kw` go to `train` (its callbacks
    after the round marks).  Returns the booster and what was
    recorded."""
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import grow_wave
    patch = patch or [(grow_wave, "fused_hist_split"),
                      (grow_wave, "split_scan")]
    owner = {key: mod for mod, key in patch}
    real = {key: getattr(mod, key) for mod, key in patch}
    events = {k: [] for k in real}
    slots_seen = []
    per_round, marks = [], []
    done = [0]

    def timed(key):
        def call(*a, **kw):
            if key.startswith("fused_hist_split"):
                slots_seen.append(int(a[3].shape[0]))
            if not timing:
                return real[key](*a, **kw)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real[key](*a, **kw)
            end.record()
            events[key].append((done[0], start, end))
            return out
        return call

    before = [counters(modules)]

    def mark_round(env):
        if timing:
            torch.cuda.synchronize()
        marks.append(time.perf_counter())
        now = counters(modules)
        per_round.append({k: now[k] - before[0][k] for k in now})
        before[0] = now
        done[0] += 1

    for key in real:
        setattr(owner[key], key, timed(key))
    try:
        t0 = time.perf_counter()
        callbacks = [mark_round] + list(train_kw.pop("callbacks", []))
        bst = lt.train(params, dataset, num_boost_round=rounds,
                       callbacks=callbacks, **train_kw)
    finally:
        for key, fn in real.items():
            setattr(owner[key], key, fn)
    out = {"per_round": per_round, "round_s": np.diff([t0] + marks),
           "max_slots": max(slots_seen) if slots_seen else 0}
    if timing:
        for key, evs in events.items():
            ms = np.zeros(rounds)
            for r, start, end in evs:
                ms[r] += start.elapsed_time(end)
            out[f"{key}_ms_per_round"] = ms
    return bst, out


def phase_train_wave(data: TrainData, modules, device=None, timing=True,
                     rounds: int = TRAIN_ROUNDS):
    """`lightgbm_tpu_torch.train` with the bench's wave configuration
    (WAVE_PARAMS) on the train phase's data: the fused run timed, a
    second fused run and an unfused run (K1 and the torch split search,
    `tpu_fused_split=False`) byte-identical to it, the held-out AUC
    within 1e-3 of `hist_impl=segment_sum`, the per-round launch and
    sync counts; then the 255-leaf, 14-wide run, fused against unfused.
    Returns the K2 and K3 launches of the main (first) run, and the
    phase's report."""
    import lightgbm_tpu_torch as lt
    params = dict(WAVE_PARAMS)
    wide = dict(WAVE_WIDE)
    if device is not None:
        params["device_type"] = wide["device_type"] = device

    # ---- the main path, alone between the counter reads
    _zero_wave_counters(modules)
    t0 = time.perf_counter()
    bst, rec = _wave_run(params, data.dataset, modules, rounds, timing)
    train_s = time.perf_counter() - t0
    total = _wave_counters(modules)
    launches = {"fused_hist_split": total["k2"], "split_scan": total["k3"]}
    _check(bst._grower_spec.fused, "train_wave: the run is not fused")
    for r, c in enumerate(rec["per_round"]):
        _check(c["k2"] == 1 + c["hist_waves"] and c["k3"] == c["hist_waves"]
               and c["k1"] == 0 and c["syncs"] == 1 + c["hist_waves"]
               and c["hist_waves"] > 0,
               f"train_wave: round {r + 1} counted {c}")
    _check(len(bst.trees) == rounds, "train_wave: bad model")
    text = bst.model_to_string()

    # ---- gates
    again = lt.train(params, data.dataset, num_boost_round=rounds)
    _check(again.model_to_string() == text,
           "train_wave: two fused runs differ")
    _zero_wave_counters(modules)
    unfused = lt.train(dict(params, tpu_fused_split=False), data.dataset,
                       num_boost_round=rounds)
    uc = _wave_counters(modules)
    _check(not unfused._grower_spec.fused and uc["k2"] == 0
           and uc["k3"] == 0 and uc["k1"] == rounds + uc["hist_waves"],
           f"train_wave: the unfused run counted {uc}")
    _check(_without(unfused.model_to_string(), "tpu_fused_split")
           == _without(text, "tpu_fused_split"),
           "train_wave: fused and unfused models differ")
    seg = lt.train(dict(params, hist_impl="segment_sum"), data.dataset,
                   num_boost_round=rounds)
    raw = bst.predict(data.X_hold, raw_score=True)
    auc_k = _auc(raw, data.y_hold)
    auc_s = _auc(seg.predict(data.X_hold, raw_score=True), data.y_hold)
    _check(abs(auc_k - auc_s) <= 1e-3,
           f"train_wave: held-out AUC {auc_k} vs segment_sum {auc_s}")
    _check(bool(np.all(np.isfinite(raw))), "train_wave: scores not finite")

    # ---- the wide run: K2 at 14 slots on the training path
    _zero_wave_counters(modules)
    wbst, wrec = _wave_run(wide, data.dataset, modules, rounds, False)
    wc = _wave_counters(modules)
    _check(wrec["max_slots"] == 14,
           f"train_wave: the wide run's widest K2 call had "
           f"{wrec['max_slots']} slots")
    wide_unfused = lt.train(dict(wide, tpu_fused_split=False), data.dataset,
                            num_boost_round=rounds)
    _check(_without(wide_unfused.model_to_string(), "tpu_fused_split")
           == _without(wbst.model_to_string(), "tpu_fused_split"),
           "train_wave: 255 leaves: fused and unfused models differ")

    trees = len(bst.trees)
    report = {"phase": "train_wave", "params": WAVE_PARAMS,
              "rows": int(data.X.shape[0]), "rounds": rounds,
              "leaves_per_tree": [t.num_leaves for t in bst.trees],
              "auc_fused": auc_k, "auc_segment_sum": auc_s,
              "model_text_identical_fused_twice": True,
              "model_text_identical_unfused": True,
              "waves": total["waves"], "hist_waves": total["hist_waves"],
              "waves_per_tree": total["waves"] / trees,
              "host_syncs": total["syncs"],
              "host_syncs_per_tree": total["syncs"] / trees,
              "per_round_counts": rec["per_round"],
              "launches": launches, "train_s": train_s,
              "wide": {"params": WAVE_WIDE,
                       "leaves_per_tree": [t.num_leaves
                                           for t in wbst.trees],
                       "max_k2_slots": wrec["max_slots"],
                       "waves_per_tree": wc["waves"] / len(wbst.trees),
                       "host_syncs_per_tree": wc["syncs"] / len(wbst.trees),
                       "k2_launches": wc["k2"], "k3_launches": wc["k3"],
                       "model_text_identical_unfused": True}}
    if timing:
        steady = rec["round_s"][1:]
        k2 = rec["fused_hist_split_ms_per_round"]
        k3 = rec["split_scan_ms_per_round"]
        report.update({
            "round_ms": [float(x) * 1e3 for x in rec["round_s"]],
            "ms_per_round_2_to_10": float(steady.mean()) * 1e3,
            "rounds_per_s_2_to_10": float(1.0 / steady.mean()),
            "k2_ms_per_round": [float(x) for x in k2],
            "k3_ms_per_round": [float(x) for x in k3],
            "k2_share_2_to_10": float(k2[1:].sum() / (steady.sum() * 1e3)),
            "k3_share_2_to_10": float(k3[1:].sum() / (steady.sum() * 1e3)),
            "wide_round_ms": [float(x) * 1e3 for x in wrec["round_s"]],
            "profiled_round": _profile_round(params, data.dataset)})
    _emit(report)
    return launches, report


# ---------------------------------------------------------- quantized
#: the quantized configurations, `benchmarks/configs_r4.py` CONFIGS on the
#: train phase's data: QUANT (`:18`) is use_quantized_grad with 15 bins;
#: "wave_w8_tail_auto+quant" (`:23`, the first and most important entry:
#: the shipped wave configuration, its strict tail auto, 16 at 31 leaves)
#: is the main run; "strict+quant" (`:37`) at the train phase's 255
#: leaves; "wave_w28_tail16+quant" (`:55`) at 255 leaves, so that its
#: waves reach 28 slots (at the configs' 31 leaves the strict tail caps
#: them at 8)
OBJECTIVE_ROWS = 2_000_000
EXP_PATTERNS = 1 << 24
#: f32 bit patterns a chunk of the link kernel's exhaustive check
LINK_CHUNK = 1 << 27


def _link_differ(fn, plain, device, lo=0, hi=1 << 32, chunk=LINK_CHUNK):
    """The inputs among the f32 bit patterns [lo, hi) where fn and plain
    give different bits (NaN payloads included), made on the card in
    chunks: (count, the first few as hex)."""
    import torch
    bad, first = 0, []
    for a in range(lo, hi, chunk):
        v = torch.arange(a, min(hi, a + chunk), dtype=torch.int64,
                         device=device)
        v = torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)
        x = v.view(torch.float32)
        diff = fn(x).view(torch.int32) != plain(x).view(torch.int32)
        n = int(diff.sum())
        if n and len(first) < 4:
            first += [f"{int(b) & 0xFFFFFFFF:#010x}"
                      for b in v[diff][:4 - len(first)].tolist()]
        bad += n
    return bad, first


def _objective_grads(name, n, seed, device):
    """grad_hess of the port's `name` objective (binary with and without
    weights, or multiclass of 3 classes) on `device`, over f32 scores
    and labels made from `seed` on the host (the same on every device)."""
    import torch
    from lightgbm_tpu_torch.objectives import create_objective
    from lightgbm_tpu_torch.utils.config import Config
    rng = np.random.RandomState(seed)
    k = 3 if name == "multiclass" else 1
    params = {"objective": "multiclass" if k > 1 else "binary",
              "verbosity": -1}
    if k > 1:
        params["num_class"] = k
    obj = create_objective(Config(params))
    label = rng.randint(0, k + (k == 1), n).astype(np.float64)
    weight = (rng.uniform(0.2, 2.0, n).astype(np.float32)
              if name == "binary_weighted" else None)
    obj.init_meta(label, weight)
    score = (rng.randn(n, k) * 4).astype(np.float32)
    score[:6, 0] = [0.0, -0.0, 90.0, -90.0, 30.0, -30.0]
    if k == 1:
        score = score[:, 0]
    t = torch.from_numpy(np.ascontiguousarray(score)).to(device)
    lt_ = torch.from_numpy(label.astype(np.float32)).to(device)
    wt = None if weight is None else torch.from_numpy(weight).to(device)
    return obj, (t, lt_, wt)


def phase_objective(seed: int, device=None, n: int = OBJECTIVE_ROWS,
                    patterns: int = EXP_PATTERNS, timing: bool = True,
                    exhaustive: bool = True):
    """The objectives' links on the card (ROADMAP Queue 3 F1): the link
    kernel (`csrc/links.cu`, through `xla_exp_f32` and `xla_sigmoid`)
    bitwise its plain version run on the card and on the CPU, on
    `patterns` f32 bit patterns (a stride through all 2^32 with a seeded
    low byte, and the edges) for exp and on `n` scores for sigmoid; on
    `n` rows, `grad_hess` of binary (with and without weights) and of
    multiclass (3 classes) on the card bitwise the same code on the CPU.
    The CPU's bits are `jnp.exp`'s and `jax.nn`'s
    (tests/test_torch_xla_math.py, scripts/check_xla_exp_exhaustive.py).
    With `exhaustive`, every one of the 2^32 f32 bit patterns through the
    kernel and the plain version on the card, for exp and for sigmoid:
    the count that differ in any bit must be 0.  Then the sigmoid
    kernel, its plain version and `torch.sigmoid` timed at `n` rows,
    with L2 warm and flushed, and binary `grad_hess`.  Returns the
    kernels-line entry (launches filled in from the main phase)."""
    import torch
    from lightgbm_tpu_torch.ops import xla_math
    dev = torch.device(device or "cuda")
    report = {"phase": "objective", "rows": n}
    rng = np.random.RandomState(seed)
    base = np.arange(patterns, dtype=np.uint64) * ((1 << 32) // patterns)
    bits = (base + rng.randint(0, (1 << 32) // patterns, patterns)
            ).astype(np.uint32)
    edges = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 88.72283,
                      88.72284, -87.33654, -87.33655, 1e-45, -1e-45,
                      3.4e38, -3.4e38], np.float32)
    x = np.concatenate([bits.view(np.float32), edges])
    scores = (rng.randn(n) * 4).astype(np.float32)
    err = 0.0
    for name, fn, plain, v in (
            ("exp", xla_math.xla_exp_f32, xla_math.xla_exp_f32_plain, x),
            ("sigmoid", xla_math.xla_sigmoid, xla_math.xla_sigmoid_plain,
             scores)):
        t = torch.from_numpy(v).to(dev)
        got = fn(t).cpu().numpy()
        want, want_cpu = plain(t).cpu().numpy(), plain(
            torch.from_numpy(v)).numpy()
        err = max(err, _max_abs_err(got, want), _max_abs_err(got, want_cpu))
        _check(_bits_equal(got, want),
               f"objective: the {name} kernel != its plain version")
        _check(_bits_equal(got, want_cpu),
               f"objective: the {name} kernel != the CPU's plain version")
        report[name] = {"values": int(v.size), "bitwise_plain": True,
                        "bitwise_cpu": True}
    if exhaustive:
        t0 = time.perf_counter()
        for name, fn, plain in (
                ("exp", xla_math.xla_exp_f32, xla_math.xla_exp_f32_plain),
                ("sigmoid", xla_math.xla_sigmoid,
                 xla_math.xla_sigmoid_plain)):
            bad, first = _link_differ(fn, plain, dev)
            report[name]["all_2_32_inputs_differ"] = bad
            report[name]["first_differing"] = first
            _check(bad == 0, f"objective: the {name} kernel differs from "
                   f"its plain version on {bad} of 2^32 inputs ({first})")
        report["exhaustive_s"] = time.perf_counter() - t0
    for name in ("binary", "binary_weighted", "multiclass"):
        obj, args = _objective_grads(name, n, seed, dev)
        g, h = obj.grad_hess(*args)
        cpu_args = tuple(None if a is None else a.cpu() for a in args)
        gc, hc = obj.grad_hess(*cpu_args)
        _check(_bits_equal(g.cpu().numpy(), gc.numpy())
               and _bits_equal(h.cpu().numpy(), hc.numpy()),
               f"objective {name}: grad_hess on the card != on the CPU")
        _check(bool(torch.isfinite(g).all()) and bool(torch.isfinite(h)
                                                      .all()),
               f"objective {name}: gradients not finite")
        report[name] = {"bitwise_cpu": True, "shape": list(g.shape)}
        if timing and name == "binary":
            report[name]["grad_hess_ms"] = _cuda_ms(
                lambda: obj.grad_hess(*args))
    t = torch.from_numpy(scores).to(dev)
    nbytes = 8 * n
    ops = 25 * n                 # about 25 f32 and f64 operations a value
    entry = {"name": "xla_link", "route": "cuda",
             "source": "lightgbm_tpu_torch/csrc/links.cu",
             "replaces": "lightgbm_tpu/objectives.py:320",
             "launches": 0, "max_abs_err": err,
             "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                             ops / F32_OPS_PER_S) * 1e3,
             "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
             >= ops / F32_OPS_PER_S else "operations",
             "ms": None, "plain_ms": None, "library_ms": None}
    cold = {}
    if timing:
        flush = _flusher(dev)
        entry["ms"] = _cuda_ms(lambda: xla_math.xla_sigmoid(t), queued=True)
        entry["plain_ms"] = _cuda_ms(lambda: xla_math.xla_sigmoid_plain(t))
        entry["library_ms"] = _cuda_ms(lambda: torch.sigmoid(t),
                                       queued=True)
        cold = {"ms_l2_cold": _cuda_ms(lambda: xla_math.xla_sigmoid(t),
                                       flush=flush),
                "library_ms_l2_cold": _cuda_ms(lambda: torch.sigmoid(t),
                                               flush=flush)}
    report["kernel"] = dict({k: entry[k] for k in (
        "ms", "plain_ms", "library_ms", "bound_ms")}, **cold)
    report["library_note"] = ("torch.sigmoid on the same scores: the same "
                              "function, torch's own rounding")
    _emit(report)
    return entry


QUANT = {"use_quantized_grad": True, "num_grad_quant_bins": 15}
QUANT_PARAMS = dict(TRAIN_PARAMS, num_leaves=31, tree_grow_policy="wave",
                    tpu_wave_width=8, tpu_wave_gain_ratio=0, **QUANT)
QUANT_STRICT = dict(TRAIN_PARAMS, **QUANT)
QUANT_WIDE = dict(TRAIN_PARAMS, tree_grow_policy="wave", tpu_wave_width=28,
                  tpu_wave_gain_ratio=0.8, tpu_wave_strict_tail=16, **QUANT)
QUANT_STRICT_ROUNDS = 3


def _quant_inputs(bnp, y, lid_np, slots, seed, dev):
    """K4/K5 inputs on `dev`: bins [F, N], the lattice [3, N] int8 of the
    binary payload of `_wave_payload` quantized to 15 levels with
    stochastic rounding (a threefry key from `seed`), leaf ids, slots
    and the scales; with the f32 payload and the quantized payload."""
    import torch
    from lightgbm_tpu_torch.ops.fused import quantize_gradients
    from lightgbm_tpu_torch.ops.hist_kernel_q import quantized_lattice_rows
    from lightgbm_tpu_torch.ops.threefry import fold_in, prng_key
    pay = torch.from_numpy(_wave_payload(y, seed)).to(dev)
    key = fold_in(prng_key(seed), 1)
    g, h, (sg, sh) = quantize_gradients(pay[:, 0].contiguous(),
                                        pay[:, 1].contiguous(), 15, key,
                                        return_scales=True)
    qpay = torch.stack([g, h, pay[:, 2]], dim=1).contiguous()
    return {"bins": torch.from_numpy(bnp).to(dev),
            "pw3": quantized_lattice_rows(qpay, sg, sh),
            "lid": torch.from_numpy(np.ascontiguousarray(lid_np)).to(dev),
            "sl": torch.tensor(slots, dtype=torch.int32, device=dev),
            "sg": sg, "sh": sh, "pay": pay, "key": key}


def _quant_cases(data, u16_rows, seed=0):
    """(name, dataset, bins [F, N], labels, leaf ids, slots) of the
    quantized kernels' phases: S = 1 at the root, on a leaf of 1% of the
    rows and on one leaf of a depth-5 partition (about 1/32 of the rows,
    a strict-tail leaf's size at 31 leaves), S = 8 over a depth-3
    partition (one slot matching no row), S = 14 over a depth-4
    partition (the same), S = 42 over a depth-6 partition, and u16 bins
    at max_bin 1023 (S = 4)."""
    import lightgbm_tpu_torch as lt
    ds = data.dataset
    wide = lt.Dataset(data.X[:u16_rows], label=data.y[:u16_rows],
                      params={"max_bin": 1023, "verbosity": -1}).construct()
    _check(wide.bin_data.dtype == np.uint16, "u16 case is not uint16")
    bins_main = np.ascontiguousarray(ds.bin_data.T)
    bins_wide = np.ascontiguousarray(wide.bin_data.T)
    lid3 = _partition(bins_main, 3)
    rng = np.random.RandomState(seed)
    n = bins_main.shape[1]
    lid_1pct = np.where(rng.rand(n) < 0.01, 0,
                        rng.randint(1, 12, n)).astype(np.int32)
    return [("root_s1", ds, bins_main, data.y, np.zeros_like(lid3), [0]),
            ("leaf_1pct", ds, bins_main, data.y, lid_1pct, [0]),
            ("leaf_s1", ds, bins_main, data.y, _partition(bins_main, 5),
             [0]),
            ("s8", ds, bins_main, data.y, lid3, list(range(7)) + [99]),
            ("s14", ds, bins_main, data.y, _partition(bins_main, 4),
             list(range(13)) + [99]),
            ("s42", ds, bins_main, data.y, _partition(bins_main, 6),
             list(range(42))),
            ("u16_1023_s4", wide, bins_wide, data.y[:u16_rows],
             _partition(bins_wide, 2), [0, 1, 2, 3])]


def _k4_bytes(inp, rows_in, mb):
    """Bytes K4 must move for these inputs: the leaf id of every row, the
    bins and three lattice bytes of each row in the slots, the f32
    histogram out (counted as `_hist_bytes` counts K1's)."""
    bins = inp["bins"]
    f, n = bins.shape
    s = inp["sl"].shape[0]
    return (n * 4 + rows_in * (f * bins.element_size() + 3)
            + s * f * mb * 12)


def phase_histogram_q(data: TrainData, seed: int, device=None,
                      u16_rows: int = 100_000, timing: bool = True):
    """K4 (`csrc/histogram_q.cu`) against its plain version on the card,
    bitwise, at the `_quant_cases` shapes; two launches bitwise equal, pad
    slots zero.  Then K4, its plain version and `index_add_` of the same
    integer histogram timed at the root, and each case's bound.  Returns
    the kernels-line entry at the root (the strict grower's shape;
    launches filled in by the train_quant phase)."""
    import torch
    from lightgbm_tpu_torch.ops import hist_kernel_q as hq
    dev = torch.device(device or "cuda")
    report = {"phase": "histogram_q", "cases": {}}
    worst = 0.0
    entry = None
    for name, d, bnp, y, lid_np, slots in _quant_cases(data, u16_rows,
                                                        seed):
        mb = max(m.num_bin for m in d.bin_mappers)
        inp = _quant_inputs(bnp, y, lid_np, slots, seed, dev)
        args = (inp["bins"], inp["pw3"], inp["lid"], inp["sl"], mb,
                inp["sg"], inp["sh"])
        k = hq.histogram_multi_quantized(*args)
        k_again = hq.histogram_multi_quantized(*args)
        plain = hq.histogram_multi_quantized_plain(*args)
        err = _max_abs_diff(k, plain)
        _check(_bits_equal(k.cpu().numpy(), plain.cpu().numpy()),
               f"histogram_q {name}: K4 != its plain version")
        _check(torch.equal(k, k_again), f"histogram_q {name}: two launches "
               "differ")
        _check(all(not bool(k[i].any()) for i, s_ in enumerate(slots)
                   if s_ == 99), f"histogram_q {name}: a pad slot is not "
               "zero")
        worst = max(worst, err)
        f, n = inp["bins"].shape
        rows_in = int((inp["lid"][:, None] == inp["sl"][None, :]).any(1)
                      .sum())
        nbytes = _k4_bytes(inp, rows_in, mb)
        adds = 3 * rows_in * f
        case = {"rows": n, "features": f, "slots": len(slots),
                "max_bin": mb, "dtype": str(bnp.dtype),
                "rows_in_slots": rows_in, "bitwise_plain": True,
                "bitwise_repro": True, "max_abs_err": err, "bytes": nbytes,
                "int_adds": adds,
                "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                                adds / INT32_OPS_PER_S) * 1e3,
                "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
                >= adds / INT32_OPS_PER_S else "operations"}
        if timing:
            case["ms"] = _cuda_ms(lambda: hq.histogram_multi_quantized(*args),
                                  queued=True)
            case["plain_ms"] = _cuda_ms(
                lambda: hq.histogram_multi_quantized_plain(*args), iters=3,
                warmup=1)
        if name == "root_s1":
            bins, pw3 = inp["bins"], inp["pw3"]
            flat = (bins.to(torch.int64) + torch.arange(
                f, device=dev)[:, None] * mb).reshape(-1)
            src = pw3.t().to(torch.int32).repeat(f, 1)

            def library():
                return torch.zeros((f * mb, 3), dtype=torch.int32,
                                   device=dev).index_add_(0, flat, src)
            lib_h = hq.dequantize(library().view(1, f, mb, 3), inp["sg"],
                                  inp["sh"])
            _check(torch.equal(lib_h, k), "histogram_q: index_add_'s "
                   "integer histogram != K4's")
            if timing:
                case["library_ms"] = _cuda_ms(library, iters=5, warmup=1)
            entry = {"name": "histogram_q", "route": "cuda",
                     "source": "lightgbm_tpu_torch/csrc/histogram_q.cu",
                     "replaces": "lightgbm_tpu/ops/pallas_hist.py:171",
                     "launches": 0, "ms": case.get("ms"),
                     "plain_ms": case.get("plain_ms"),
                     "bound_ms": case["bound_ms"],
                     "bound_by": case["bound_by"],
                     "library_ms": case.get("library_ms")}
        report["cases"][name] = case
    entry["max_abs_err"] = worst
    report["max_abs_err"] = worst
    report["library_note"] = ("index_add_ of the int32 lattice at the "
                              "root: the same integer histogram (one slot "
                              "holding every row), before the dequantize")
    _emit(report)
    return entry


def phase_fused_q(data: TrainData, seed: int, device=None,
                  u16_rows: int = 100_000, timing: bool = True):
    """K5 (`csrc/fused_split.cu`) at the `_quant_cases` shapes: its
    histogram bitwise K4's and its plain version's, its candidates bitwise
    the plain scan's and K3's over the same histogram, two launches
    bitwise equal; the quantizer's stochastic rounding on the card bitwise
    the same call on the CPU.  Then K5, its plain version, K4 and K3 (over
    K5's histogram) timed, and the bounds.  Returns the kernels-line
    entry at S = 8 (launches filled in by the train_quant phase)."""
    import torch
    from lightgbm_tpu_torch.ops import fused_kernel as fk
    from lightgbm_tpu_torch.ops import hist_kernel_q as hq
    from lightgbm_tpu_torch.ops.fused import quantize_gradients
    dev = torch.device(device or "cuda")
    kw = FUSED_SCAN_KW
    report = {"phase": "fused_q", "scan_kw": kw, "cases": {}}
    worst = 0.0
    entry = None
    for name, d, bnp, y, lid_np, slots in _quant_cases(data, u16_rows,
                                                        seed):
        mb = max(m.num_bin for m in d.bin_mappers)
        f = bnp.shape[0]
        inp = _quant_inputs(bnp, y, lid_np, slots, seed, dev)
        if name == "root_s1":
            # threefry and the quantizer are integer and IEEE f32 ops: the
            # card's lattice equals the CPU's over the same f32 gradients
            pay = inp["pay"]
            got = quantize_gradients(pay[:, 0].contiguous(),
                                     pay[:, 1].contiguous(), 15,
                                     inp["key"], return_scales=True)
            cpu = pay.cpu()
            want = quantize_gradients(cpu[:, 0].contiguous(),
                                      cpu[:, 1].contiguous(), 15,
                                      inp["key"], return_scales=True)
            for a, b in ((got[0], want[0]), (got[1], want[1]),
                         (got[2][0], want[2][0]), (got[2][1], want[2][1])):
                _check(_bits_equal(a.cpu().numpy(), b.numpy()),
                       "fused_q: quantize_gradients on the card != CPU")
        nb = torch.tensor([m.num_bin for m in d.bin_mappers],
                          dtype=torch.int32, device=dev)
        miss = torch.arange(f, dtype=torch.int32, device=dev) % 3
        base = (inp["bins"], inp["pw3"], inp["lid"], inp["sl"])
        k4 = hq.histogram_multi_quantized(*base, mb, inp["sg"], inp["sh"])
        parent = k4[:, 0].sum(dim=1).contiguous()            # [S, 3]
        args = base + (nb, miss, parent, mb, inp["sg"], inp["sh"])
        h5, c5 = fk.fused_hist_split_quantized(*args, **kw)
        h5b, c5b = fk.fused_hist_split_quantized(*args, **kw)
        hp, cp = fk.fused_hist_split_quantized_plain(*args, **kw)
        c3 = fk.split_scan(h5, nb, miss, parent, **kw)
        scan = fk.split_scan_plain(h5, nb, miss, parent, **kw)
        h5n, c5n = h5.cpu().numpy(), c5.cpu().numpy()
        _check(_bits_equal(h5n, k4.cpu().numpy()),
               f"fused_q {name}: K5's histogram != K4's")
        _check(_bits_equal(h5n, hp.cpu().numpy())
               and _bits_equal(c5n, cp.cpu().numpy()),
               f"fused_q {name}: K5 != its plain version")
        _check(_bits_equal(c5n, scan.cpu().numpy()),
               f"fused_q {name}: K5's candidates != the plain scan")
        _check(_bits_equal(c3.cpu().numpy(), c5n),
               f"fused_q {name}: K3's candidates != K5's")
        _check(_bits_equal(h5b.cpu().numpy(), h5n)
               and _bits_equal(c5b.cpu().numpy(), c5n),
               f"fused_q {name}: two launches differ")
        err = max(_max_abs_diff(h5, hp), _max_abs_diff(c5, cp))
        worst = max(worst, err)
        n = bnp.shape[1]
        s = len(slots)
        rows_in = int((inp["lid"][:, None] == inp["sl"][None, :]).any(1)
                      .sum())
        nbytes = _k4_bytes(inp, rows_in, mb) + s * 2 * f * 32
        adds = 3 * rows_in * f
        scan_ops = s * f * mb * SCAN_OPS_PER_BIN
        op_s = adds / INT32_OPS_PER_S + scan_ops / F32_OPS_PER_S
        case = {"rows": n, "features": f, "slots": s, "max_bin": mb,
                "dtype": str(bnp.dtype), "rows_in_slots": rows_in,
                "hist_bitwise_k4": True, "bitwise_plain": True,
                "cand_bitwise_plain_scan": True, "k3_bitwise_k5": True,
                "bitwise_repro": True, "max_abs_err": err,
                "splits_found": int((c5[:, :, :, 0] > float("-inf")).any(2)
                                    .any(1).sum()),
                "bytes": nbytes, "int_adds": adds, "scan_ops": scan_ops,
                "bound_ms": max(nbytes / HBM_BYTES_PER_S, op_s) * 1e3,
                "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= op_s
                else "operations"}
        if timing:
            case["ms"] = _cuda_ms(lambda: fk.fused_hist_split_quantized(
                *args, **kw), queued=True)
            case["plain_ms"] = _cuda_ms(
                lambda: fk.fused_hist_split_quantized_plain(*args, **kw),
                iters=3, warmup=1)
            case["k4_ms"] = _cuda_ms(lambda: hq.histogram_multi_quantized(
                *base, mb, inp["sg"], inp["sh"]), queued=True)
            case["k3_ms"] = _cuda_ms(lambda: fk.split_scan(
                h5, nb, miss, parent, **kw), queued=True)
        case["k3_bound_ms"] = _bound(s * f * mb * 12 + s * 2 * f * 32,
                                     scan_ops, F32_OPS_PER_S)[0]
        report["cases"][name] = case
        if name == "s8":
            entry = {"name": "fused_hist_split_q", "route": "cuda",
                     "source": "lightgbm_tpu_torch/csrc/fused_split.cu",
                     "replaces": "lightgbm_tpu/ops/pallas_hist.py:524",
                     "launches": 0, "ms": case.get("ms"),
                     "plain_ms": case.get("plain_ms"),
                     "bound_ms": case["bound_ms"],
                     "bound_by": case["bound_by"], "library_ms": None}
    entry["max_abs_err"] = worst
    report["max_abs_err"] = worst
    report["quantize_bitwise_cpu"] = True
    report["library_ms"] = None
    report["library_note"] = ("no single PyTorch call builds a histogram "
                              "and scans it")
    _emit(report)
    return entry


def _quant_counters(modules):
    from lightgbm_tpu_torch.ops import grow as grow_module
    from lightgbm_tpu_torch.ops import grow_wave
    from lightgbm_tpu_torch.ops import threefry
    return {"k5": modules["fused"].FUSED_Q_LAUNCHES,
            "k3": modules["fused"].SCAN_LAUNCHES,
            "k4": modules["hist_q"].HIST_Q_LAUNCHES,
            "k2": modules["fused"].FUSED_LAUNCHES,
            "k1": modules["hist"].HIST_LAUNCHES,
            "threefry": threefry.THREEFRY_LAUNCHES,
            "syncs": grow_module.HOST_SYNCS, "waves": grow_wave.WAVES,
            "hist_waves": grow_wave.HIST_WAVES}


def _zero_quant_counters(modules):
    from lightgbm_tpu_torch.ops import threefry
    _zero_wave_counters(modules)
    modules["fused"].FUSED_Q_LAUNCHES = 0
    modules["hist_q"].HIST_Q_LAUNCHES = 0
    threefry.THREEFRY_LAUNCHES = 0


def phase_train_quant(data: TrainData, modules, device=None, timing=True,
                      rounds: int = TRAIN_ROUNDS, f32_wave=None):
    """`lightgbm_tpu_torch.train` with quantized gradients on the train
    phase's data.  The main run, QUANT_PARAMS (`wave_w8_tail_auto+quant`),
    timed: per round K5 launches = 1 + waves that built histograms, K3
    launches = those waves, no K1, K2 or K4 launch; a second run, an
    unfused run (K4 and the torch split search) and a `hist_impl=packed`
    run (the plain packed histogram on the card) all give byte-identical
    model text; the held-out AUC beside the f32 wave model's of the same
    call (`f32_wave`, the train_wave report).  Then QUANT_STRICT at 255
    leaves (K4 at S = 1: launches = rounds + splits; `packed`
    byte-identical) and QUANT_WIDE (K5 at 28 slots; unfused
    byte-identical), each between its own counter reads.  Returns the
    K5 and K3 launches of the main run and K4's of the strict run."""
    import torch
    import lightgbm_tpu_torch as lt
    import lightgbm_tpu_torch.booster as booster_module
    from lightgbm_tpu_torch.ops import grow_wave
    params, strict, wide = (dict(QUANT_PARAMS), dict(QUANT_STRICT),
                            dict(QUANT_WIDE))
    if device is not None:
        for p in (params, strict, wide):
            p["device_type"] = device
    f32_wave = f32_wave or {}

    # ---- the main path, alone between the counter reads
    _zero_quant_counters(modules)
    t0 = time.perf_counter()
    bst, rec = _wave_run(
        params, data.dataset, modules, rounds, timing,
        patch=[(grow_wave, "fused_hist_split_quantized"),
               (grow_wave, "split_scan"),
               (booster_module, "quantize_gradients")],
        counters=_quant_counters)
    train_s = time.perf_counter() - t0
    total = _quant_counters(modules)
    launches = {"fused_hist_split_q": total["k5"],
                "split_scan": total["k3"], "threefry": total["threefry"]}
    spec = bst._grower_spec
    _check(spec.fused and spec.hist_impl == "kernel_q"
           and spec.wave_strict_tail == 16 and spec.wave_width == 8,
           f"train_quant: the main run resolved to {spec}")
    for r, c in enumerate(rec["per_round"]):
        # the quantizer's two draws (g and h) are one threefry launch each
        _check(c["k5"] == 1 + c["hist_waves"] and c["k3"] == c["hist_waves"]
               and c["k1"] == 0 and c["k2"] == 0 and c["k4"] == 0
               and c["threefry"] == 2
               and c["syncs"] == 1 + c["hist_waves"] and c["hist_waves"] > 0,
               f"train_quant: round {r + 1} counted {c}")
    _check(len(bst.trees) == rounds, "train_quant: bad model")
    text = bst.model_to_string()

    # ---- gates: the same model four ways
    again = lt.train(params, data.dataset, num_boost_round=rounds)
    _check(again.model_to_string() == text,
           "train_quant: two kernel runs differ")
    _zero_quant_counters(modules)
    unfused = lt.train(dict(params, tpu_fused_split=False), data.dataset,
                       num_boost_round=rounds)
    uc = _quant_counters(modules)
    _check(not unfused._grower_spec.fused and uc["k5"] == 0
           and uc["k3"] == 0 and uc["k4"] == rounds + uc["hist_waves"],
           f"train_quant: the unfused run counted {uc}")
    _check(_without(unfused.model_to_string(), "tpu_fused_split")
           == _without(text, "tpu_fused_split"),
           "train_quant: fused and unfused models differ")
    _zero_quant_counters(modules)
    packed = lt.train(dict(params, hist_impl="packed"), data.dataset,
                      num_boost_round=rounds)
    pc = _quant_counters(modules)
    _check(packed.hist_impl == "packed" and pc["k4"] == 0 and pc["k5"] == 0,
           f"train_quant: the packed run counted {pc}")
    _check(_without(packed.model_to_string(), "hist_impl")
           == _without(text, "hist_impl"),
           "train_quant: kernel and packed models differ")
    raw = bst.predict(data.X_hold, raw_score=True)
    _check(bool(np.all(np.isfinite(raw))), "train_quant: scores not finite")
    auc_q = _auc(raw, data.y_hold)
    auc_f32 = f32_wave.get("auc_fused")
    _check(auc_f32 is None or abs(auc_q - auc_f32) <= 0.02,
           f"train_quant: held-out AUC {auc_q} vs the f32 wave's {auc_f32}")

    # ---- strict+quant at 255 leaves: K4 at S = 1
    _zero_quant_counters(modules)
    marks = [time.perf_counter()]

    def mark(env):
        if timing:
            torch.cuda.synchronize()
        marks.append(time.perf_counter())
    sbst = lt.train(strict, data.dataset, num_boost_round=QUANT_STRICT_ROUNDS,
                    callbacks=[mark])
    strict_round_s = np.diff(marks)
    sc = _quant_counters(modules)
    splits = sum(t.num_leaves - 1 for t in sbst.trees)
    launches["histogram_q"] = sc["k4"]
    _check(sbst.hist_impl == "kernel_q" and sc["k5"] == 0
           and sc["k4"] == QUANT_STRICT_ROUNDS + splits,
           f"train_quant: strict run counted {sc} for {splits} splits")
    spacked = lt.train(dict(strict, hist_impl="packed"), data.dataset,
                       num_boost_round=QUANT_STRICT_ROUNDS)
    _check(_without(spacked.model_to_string(), "hist_impl")
           == _without(sbst.model_to_string(), "hist_impl"),
           "train_quant: strict kernel and packed models differ")

    # ---- wave_w28_tail16+quant at 255 leaves: K5 at 28 slots
    _zero_quant_counters(modules)
    wbst, wrec = _wave_run(wide, data.dataset, modules, rounds, False,
                           patch=[(grow_wave, "fused_hist_split_quantized")],
                           counters=_quant_counters)
    wc = _quant_counters(modules)
    _check(wrec["max_slots"] == 28,
           f"train_quant: the wide run's widest K5 call had "
           f"{wrec['max_slots']} slots")
    wide_unfused = lt.train(dict(wide, tpu_fused_split=False), data.dataset,
                            num_boost_round=rounds)
    _check(_without(wide_unfused.model_to_string(), "tpu_fused_split")
           == _without(wbst.model_to_string(), "tpu_fused_split"),
           "train_quant: 255 leaves: fused and unfused models differ")

    trees = len(bst.trees)
    report = {"phase": "train_quant", "params": QUANT_PARAMS,
              "rows": int(data.X.shape[0]), "rounds": rounds,
              "leaves_per_tree": [t.num_leaves for t in bst.trees],
              "auc_quant": auc_q, "auc_f32_wave": auc_f32,
              "model_text_identical_twice": True,
              "model_text_identical_unfused": True,
              "model_text_identical_packed": True,
              "waves": total["waves"], "hist_waves": total["hist_waves"],
              "waves_per_tree": total["waves"] / trees,
              "host_syncs_per_tree": total["syncs"] / trees,
              "per_round_counts": rec["per_round"],
              "launches": launches, "train_s": train_s,
              "strict": {"params": QUANT_STRICT,
                         "rounds": QUANT_STRICT_ROUNDS, "splits": splits,
                         "k4_launches": sc["k4"],
                         "train_s": float(strict_round_s.sum()),
                         "leaves_per_tree": [t.num_leaves
                                             for t in sbst.trees],
                         "model_text_identical_packed": True},
              "wide": {"params": QUANT_WIDE,
                       "leaves_per_tree": [t.num_leaves
                                           for t in wbst.trees],
                       "max_k5_slots": wrec["max_slots"],
                       "waves_per_tree": wc["waves"] / len(wbst.trees),
                       "k5_launches": wc["k5"], "k3_launches": wc["k3"],
                       "model_text_identical_unfused": True}}
    if timing:
        steady = rec["round_s"][1:]
        k5 = rec["fused_hist_split_quantized_ms_per_round"]
        k3 = rec["split_scan_ms_per_round"]
        qz = rec["quantize_gradients_ms_per_round"]
        report.update({
            "round_ms": [float(x) * 1e3 for x in rec["round_s"]],
            "ms_per_round_2_to_10": float(steady.mean()) * 1e3,
            "f32_wave_ms_per_round_2_to_10":
                f32_wave.get("ms_per_round_2_to_10"),
            "k5_ms_per_round": [float(x) for x in k5],
            "k3_ms_per_round": [float(x) for x in k3],
            "quantize_ms_per_round": [float(x) for x in qz],
            "k5_share_2_to_10": float(k5[1:].sum() / (steady.sum() * 1e3)),
            "quantize_share_2_to_10": float(qz[1:].sum()
                                            / (steady.sum() * 1e3)),
            "strict_round_ms": [float(x) * 1e3 for x in strict_round_s],
            "strict_ms_per_round_2_to_3": float(strict_round_s[1:].mean())
            * 1e3,
            "wide_round_ms": [float(x) * 1e3 for x in wrec["round_s"]],
            "profiled_round": _profile_round(params, data.dataset),
            "strict_profiled_round": _profile_round(strict,
                                                    data.dataset)})
    _emit(report)
    return launches


# ------------------------------------------------------------ samplers
#: the threefry kernel's operations a value by the code (`csrc/threefry.cu
#: threefry_bits`), by the lanes that can run them: 20 rotations (a
#: funnel shift each) and 21 xors (a round's, the final one) only on the
#: INT32 lanes; 32 adds (the key's 2, the rounds' 20, 2 at each of the 5
#: injections, their constant folded into the key word) there or as IMAD;
#: the uniform mode's shift and or (INT32 lanes) and f32 subtract
THREEFRY_OPS = {False: {"int32_only": 41, "adds": 32, "f32": 0},
                True: {"int32_only": 43, "adds": 32, "f32": 1}}
#: the sampled configurations: bagging and feature_fraction on the bench's
#: wave (WAVE_PARAMS, `configs_r4.py:44` "wave_w8_tail16") and on its
#: quantized twin (QUANT_PARAMS); GOSS as `benchmarks/bench_families.py:147`
#: runs it (the bench's wave, 31 leaves, learning rate 0.1, top_rate 0.2,
#: other_rate 0.1), 14 rounds so that rounds 10-13 sample; per-node
#: sampling on the strict grower at the train phase's 255 leaves
SAMPLING = {"bagging_fraction": 0.8, "bagging_freq": 1,
            "feature_fraction": 0.8}
SAMPLED_WAVE = dict(WAVE_PARAMS, **SAMPLING)
SAMPLED_QUANT = dict(QUANT_PARAMS, **SAMPLING)
GOSS_PARAMS = dict(WAVE_PARAMS, boosting="goss")
GOSS_ROUNDS = 14
NODE_PARAMS = dict(TRAIN_PARAMS, feature_fraction_bynode=0.5,
                   extra_trees=True)
NODE_ROUNDS = 3
#: the kernel phase's per-row-key batch: a 255-leaf tree's node ids
#: (2 x 255 - 1) by the train phase's features
NODE_BATCH = (509, TRAIN_FEATURES)


def _threefry_bound(count: int, uniform: bool):
    """(bound ms, bound_by) of `count` threefry values: their 4-byte
    outputs written once, and their operations (THREEFRY_OPS) on the
    INT32 lanes or through the schedulers' dispatch, whichever takes
    longer."""
    ops = THREEFRY_OPS[uniform]
    t_o = count * max(ops["int32_only"] / INT32_OPS_PER_S,
                      sum(ops.values()) / DISPATCH_LANES_PER_S)
    t_b = 4 * count / HBM_BYTES_PER_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def _sass_mix(name: str, kernel: str):
    """{function: {"instructions": {mnemonic: count}, "per_hash": ...}}
    of the SASS in library `name`'s build (`cuobjdump -sass`), for each
    function whose mangled name holds `kernel`.  `per_hash` divides the
    counts by the function's hashes, its wrapping funnel shifts / 20
    (one a rotation)."""
    from lightgbm_tpu_torch.compiler import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout
    mix, fn = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1) if kernel in m.group(1) else None
            if fn:
                mix[fn] = {}
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)", line)
        if fn and m:
            mix[fn][m.group(1)] = mix[fn].get(m.group(1), 0) + 1
    out = {}
    for fn, ops in mix.items():
        rot = sum(c for op, c in ops.items() if op.startswith("SHF.L.W"))
        out[fn] = {"instructions": ops, "funnel_shifts": rot,
                   "per_hash": ({op: c * 20 / rot for op, c in ops.items()}
                                if rot else None)}
    return out


def phase_threefry(seed: int, device=None, n: int = TRAIN_ROWS,
                   timing: bool = True):
    """The threefry kernel (`csrc/threefry.cu`, through
    `ops/threefry.py draw`) bitwise its plain version on the card and on
    the CPU: bits and uniforms under 4 keys at n = 1, 31 and n + 3 (the
    scalar tail), and a NODE_BATCH draw with one key a row (bits,
    uniforms and the permutations sorted from them).  Then the 2M
    uniform draw (the bagging, GOSS and quantizer draws), its bits and
    the batch timed L2-warm, queued behind a spin kernel, beside the
    bound of their operations and bytes (`_threefry_bound`) and the
    plain version, and the kernel's SASS mix.  Returns the kernels-line
    entry (launches filled in from train_sampled)."""
    import torch
    from lightgbm_tpu_torch.ops import threefry as tf
    dev = torch.device(device or "cuda")
    keys = tf.fold_in(tf.prng_key(seed), [0, 1, 2, 3])
    report = {"phase": "threefry", "cases": []}
    err = 0.0
    for i in range(keys.shape[0]):
        for m in (1, 31, n + 3):
            for uni in (False, True):
                got = tf.draw(keys[i], m, uni, dev)
                plain = tf.draw_plain(keys[i:i + 1], m, uni, dev)
                cpu = tf.draw_plain(keys[i:i + 1], m, uni, "cpu")
                g = got.cpu()
                _check(torch.equal(g, plain.cpu()) and torch.equal(g, cpu),
                       f"threefry: key {i}, n {m}, uniform {uni}: the "
                       "kernel != its plain version")
                if uni:
                    err = max(err, _max_abs_err(g.numpy(), cpu.numpy()))
                report["cases"].append([i, m, uni])
    rows, f = NODE_BATCH
    node_keys = tf.fold_in(keys[0], torch.arange(rows))
    for uni in (False, True):
        got = tf.draw(node_keys, f, uni, dev).cpu()
        _check(torch.equal(got, tf.draw_plain(node_keys, f, uni, dev).cpu())
               and torch.equal(got, tf.draw_plain(node_keys, f, uni,
                                                  "cpu")),
               f"threefry: the {rows} x {f} batch (uniform {uni}) != its "
               "plain version")
    _check(torch.equal(tf.permutation(node_keys, f, dev).cpu(),
                       tf.permutation(node_keys, f, "cpu")),
           "threefry: the batch's permutations differ from the CPU's")
    report["batch"] = {"rows": rows, "n": f, "bitwise": True}
    key = keys[0]
    b_ms, b_by = _threefry_bound(n, True)
    entry = {"name": "threefry", "route": "cuda",
             "source": "lightgbm_tpu_torch/csrc/threefry.cu",
             "replaces": "lightgbm_tpu/ops/fused.py:38", "launches": 0,
             "max_abs_err": err, "ms": None, "plain_ms": None,
             "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    if timing:
        entry["ms"] = _cuda_ms(lambda: tf.uniform(key, (n,), dev),
                               queued=True)
        entry["plain_ms"] = _cuda_ms(
            lambda: tf.draw_plain(key.reshape(1, 2), n, True, dev))
        bb_ms, bb_by = _threefry_bound(rows * f, True)
        report["timing"] = {
            "uniform_2m": {"ms": entry["ms"], "plain_ms": entry["plain_ms"],
                           "bound_ms": b_ms, "bound_by": b_by},
            "bits_2m": {"ms": _cuda_ms(lambda: tf.draw(key, n, False, dev),
                                       queued=True),
                        "bound_ms": _threefry_bound(n, False)[0]},
            "batch": {"ms": _cuda_ms(lambda: tf.draw(node_keys, f, True,
                                                     dev), queued=True),
                      "plain_ms": _cuda_ms(lambda: tf.draw_plain(
                          node_keys, f, True, dev)),
                      "bound_ms": bb_ms, "bound_by": bb_by}}
        report["ops_per_value"] = {"bits": THREEFRY_OPS[False],
                                   "uniform": THREEFRY_OPS[True]}
        try:
            report["sass"] = _sass_mix("threefry", "threefry_kernel")
        except (OSError, subprocess.SubprocessError) as e:
            report["sass"] = {"error": str(e)}
    report["library_note"] = ("no PyTorch call draws threefry2x32 "
                              "(torch.rand is Philox: other numbers)")
    _emit(report)
    return entry


class _Recorder:
    """Wraps `owner.name` for the length of a `with`: every call's
    arguments and result (cloned, left on the device) are kept."""

    def __init__(self, owner, name):
        self.owner, self.name = owner, name
        self.real = getattr(owner, name)
        self.calls = []

    def __enter__(self):
        def call(*a, **kw):
            out = self.real(*a, **kw)
            self.calls.append((a, kw, _clone(out)))
            return out
        setattr(self.owner, self.name, call)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.real)


def _clone(x):
    import torch
    if isinstance(x, torch.Tensor):
        return x.clone()
    if hasattr(x, "_fields"):                   # a NamedTuple
        return type(x)(*(_clone(v) for v in x))
    return x


def _cpu(x):
    import torch
    return x.cpu() if isinstance(x, torch.Tensor) else x


def _sampled_wave(data, params, modules, rounds, timing, quantized):
    """One sampled wave configuration: the main run (per-round launches;
    every round's bagging weights and every tree's feature mask on the
    card bitwise the CPU's from the same keys), a second run and an
    unfused run byte-identical to it."""
    import lightgbm_tpu_torch as lt
    import lightgbm_tpu_torch.booster as booster_module
    from lightgbm_tpu_torch.ops import fused
    from lightgbm_tpu_torch.ops import grow_wave
    kind = "quantized" if quantized else "f32"
    patch = [(grow_wave, "fused_hist_split_quantized" if quantized
              else "fused_hist_split"), (grow_wave, "split_scan")]
    _zero_quant_counters(modules)
    with _Recorder(booster_module, "bagging_weights") as bag, \
            _Recorder(booster_module, "feature_mask") as ff:
        bst, rec = _wave_run(params, data.dataset, modules, rounds, timing,
                             patch=patch, counters=_quant_counters)
    total = _quant_counters(modules)
    spec = bst._grower_spec
    _check(spec.fused and spec.hist_impl == ("kernel_q" if quantized
                                             else "kernel"),
           f"train_sampled {kind}: the run resolved to {spec}")
    main = "k5" if quantized else "k2"
    for r, c in enumerate(rec["per_round"]):
        # one draw for the bag, one for the tree's features, and the
        # quantizer's two
        _check(c[main] == 1 + c["hist_waves"] and c["k3"] == c["hist_waves"]
               and c["k1"] == 0 and c["k4"] == 0
               and c["threefry"] == 2 + 2 * quantized
               and c["syncs"] == 1 + c["hist_waves"],
               f"train_sampled {kind}: round {r + 1} counted {c}")
    _check(len(bag.calls) == rounds and len(ff.calls) == rounds,
           f"train_sampled {kind}: {len(bag.calls)} bags and "
           f"{len(ff.calls)} feature masks in {rounds} rounds")
    for a, kw, out in bag.calls:
        cpu = fused.bagging_weights(*a[:3], "cpu", **kw)
        _check(_bits_equal(out.cpu().numpy(), cpu.numpy()),
               f"train_sampled {kind}: round {a[0]}'s bag != the CPU's")
    for a, kw, out in ff.calls:
        cpu = fused.feature_mask(*(_cpu(v) for v in a), **kw)
        _check(bool(out.cpu().eq(cpu).all()) and int(cpu.sum()) < cpu.numel(),
               f"train_sampled {kind}: tree {a[:2]}'s features != the CPU's")
    text = bst.model_to_string()
    again = lt.train(params, data.dataset, num_boost_round=rounds)
    _check(again.model_to_string() == text,
           f"train_sampled {kind}: two runs differ")
    _zero_quant_counters(modules)
    unfused = lt.train(dict(params, tpu_fused_split=False), data.dataset,
                       num_boost_round=rounds)
    uc = _quant_counters(modules)
    unfused_hist = "k4" if quantized else "k1"
    _check(not unfused._grower_spec.fused and uc[main] == 0
           and uc[unfused_hist] == rounds + uc["hist_waves"],
           f"train_sampled {kind}: the unfused run counted {uc}")
    _check(_without(unfused.model_to_string(), "tpu_fused_split")
           == _without(text, "tpu_fused_split"),
           f"train_sampled {kind}: fused and unfused models differ")
    raw = bst.predict(data.X_hold, raw_score=True)
    _check(bool(np.all(np.isfinite(raw))),
           f"train_sampled {kind}: scores not finite")
    out = {"params": params, "rounds": rounds,
           "leaves_per_tree": [t.num_leaves for t in bst.trees],
           "auc": _auc(raw, data.y_hold),
           "bags_bitwise_cpu": len(bag.calls),
           "feature_masks_bitwise_cpu": len(ff.calls),
           "bag_rows_mean": float(np.mean([float(o.sum()) for _, _, o
                                           in bag.calls])),
           "model_text_identical_twice": True,
           "model_text_identical_unfused": True,
           "launches": {k: total[k] for k in ("threefry", main, "k3")},
           "per_round_counts": rec["per_round"]}
    if timing:
        steady = rec["round_s"][1:]
        out.update({
            "round_ms": [float(x) * 1e3 for x in rec["round_s"]],
            "ms_per_round_2_to_10": float(steady.mean()) * 1e3,
            "profiled_round": _profile_round(params, data.dataset)})
    return out


def phase_train_sampled(data: TrainData, modules, device=None,
                        timing: bool = True, rounds: int = TRAIN_ROUNDS,
                        f32_wave=None):
    """`lightgbm_tpu_torch.train` with the samplers on the train phase's
    data.  (a) Bagging and feature_fraction on the bench's wave, f32
    (K2/K3, the main run, between its own counter reads) and quantized
    (K5/K3): per round one threefry launch for the bag and one for the
    tree's features (and the quantizer's two), every bag and mask bitwise
    the CPU's, two runs and the unfused run byte-identical, the held-out
    AUC within 0.02 of the unsampled f32 wave's of the same call
    (`f32_wave`).  (b) GOSS (bench_families' goss) for GOSS_ROUNDS: every
    sampled round's weights bitwise the CPU's from the card's gradients,
    two runs byte-identical, and with `use_quantized_grad` the f32
    histograms and the reference's warning.  (c) bynode and extra_trees
    on the strict grower at 255 leaves: every tree's node masks bitwise
    the CPU's, two runs byte-identical, one host sync per split and one a
    tree, as unsampled.  Returns the main run's threefry launches."""
    import torch
    import lightgbm_tpu_torch as lt
    import lightgbm_tpu_torch.booster as booster_module
    import lightgbm_tpu_torch.ops.grow as grow_module
    from lightgbm_tpu_torch.ops import fused
    from lightgbm_tpu_torch.utils import log as log_module
    f32_wave = f32_wave or {}
    params = [dict(p) for p in (SAMPLED_WAVE, SAMPLED_QUANT, GOSS_PARAMS,
                                NODE_PARAMS, TRAIN_PARAMS)]
    if device is not None:
        for p in params:
            p["device_type"] = device
    wave_p, quant_p, goss_p, node_p, strict_p = params
    report = {"phase": "train_sampled", "rows": int(data.X.shape[0])}

    # ---- (a) bagging + feature_fraction; the f32 run is the main path
    report["wave_f32"] = _sampled_wave(data, wave_p, modules, rounds,
                                       timing, quantized=False)
    launches = report["wave_f32"]["launches"]["threefry"]
    report["wave_quant"] = _sampled_wave(data, quant_p, modules, rounds,
                                         timing, quantized=True)
    auc_f32 = f32_wave.get("auc_fused")
    for key in ("wave_f32", "wave_quant"):
        auc = report[key]["auc"]
        _check(auc_f32 is None or abs(auc - auc_f32) <= 0.02,
               f"train_sampled {key}: held-out AUC {auc} vs the unsampled "
               f"f32 wave's {auc_f32}")
    report["auc_unsampled_f32_wave"] = auc_f32
    report["unsampled_f32_wave_ms_per_round_2_to_10"] = f32_wave.get(
        "ms_per_round_2_to_10")

    # ---- (b) GOSS: rounds 10-13 sample
    _zero_quant_counters(modules)
    with _Recorder(booster_module, "goss_weights") as goss:
        t0 = time.perf_counter()
        gbst, grec = _wave_run(goss_p, data.dataset, modules, GOSS_ROUNDS,
                               timing, counters=_quant_counters)
        goss_s = time.perf_counter() - t0
    start = int(1.0 / goss_p["learning_rate"])
    _check([a[0] for a, _, _ in goss.calls]
           == list(range(start, GOSS_ROUNDS)),
           f"train_sampled goss: sampled iterations "
           f"{[a[0] for a, _, _ in goss.calls]}")
    for r, c in enumerate(grec["per_round"]):
        _check(c["threefry"] == (r >= start)
               and c["k2"] == 1 + c["hist_waves"],
               f"train_sampled goss: round {r + 1} counted {c}")
    kept = []
    for a, kw, out in goss.calls:
        it, key0, g, h = a
        cpu = fused.goss_weights(it, key0, g.cpu(), h.cpu(), **kw)
        w = out.cpu()
        _check(_bits_equal(w.numpy(), cpu.numpy()),
               f"train_sampled goss: iteration {it}'s weights != the CPU's")
        _check(float(w.min()) == 0.0 and float(w.max()) > 1.0,
               f"train_sampled goss: iteration {it} did not sample")
        kept.append(int((w > 0).sum()))
    gtext = gbst.model_to_string()
    _check(lt.train(goss_p, data.dataset, num_boost_round=GOSS_ROUNDS)
           .model_to_string() == gtext, "train_sampled goss: two runs differ")
    warned = []
    real_warning = log_module.warning
    log_module.warning = lambda msg: (warned.append(msg), real_warning(msg))
    try:
        _zero_quant_counters(modules)
        qgoss = lt.train(dict(goss_p, **QUANT), data.dataset,
                         num_boost_round=GOSS_ROUNDS)
    finally:
        log_module.warning = real_warning
    qc = _quant_counters(modules)
    _check(qgoss.hist_impl == "kernel" and qgoss._grower_spec.fused
           and qc["k5"] == 0 and qc["k4"] == 0 and qc["k2"] > 0
           and any("GOSS rescale weights break lattice integrality" in m
                   for m in warned),
           f"train_sampled goss: quantized GOSS resolved to "
           f"{qgoss.hist_impl}, counted {qc}, warned {warned}")
    raw = gbst.predict(data.X_hold, raw_score=True)
    _check(bool(np.all(np.isfinite(raw))) and bool(np.all(np.isfinite(
        qgoss.predict(data.X_hold, raw_score=True)))),
        "train_sampled goss: scores not finite")
    report["goss"] = {
        "params": GOSS_PARAMS, "rounds": GOSS_ROUNDS,
        "sampled_iterations": [a[0] for a, _, _ in goss.calls],
        "rows_kept": kept, "weights_bitwise_cpu": len(goss.calls),
        "auc": _auc(raw, data.y_hold), "model_text_identical_twice": True,
        "quantized_hist_impl": qgoss.hist_impl,
        "quantized_warning": [m for m in warned if "GOSS" in m][:1],
        "per_round_counts": grec["per_round"], "train_s": goss_s}
    if timing:
        report["goss"]["round_ms"] = [float(x) * 1e3
                                      for x in grec["round_s"]]

    # ---- (c) bynode + extra_trees on the strict grower, 255 leaves
    def strict_run(p):
        grow_module.HOST_SYNCS = 0
        before = _quant_counters(modules)["threefry"]
        marks = [time.perf_counter()]

        def mark(env):
            if timing:
                torch.cuda.synchronize()
            marks.append(time.perf_counter())
        b = lt.train(p, data.dataset, num_boost_round=NODE_ROUNDS,
                     callbacks=[mark])
        splits = sum(t.num_leaves - 1 for t in b.trees)
        return b, {"syncs": grow_module.HOST_SYNCS, "splits": splits,
                   "trees": len(b.trees),
                   "threefry": _quant_counters(modules)["threefry"] - before,
                   "round_ms": [float(x) * 1e3 for x in np.diff(marks)]}

    with _Recorder(grow_module, "make_node_samplers") as nodes:
        nbst, nc = strict_run(node_p)
    plain_bst, pc = strict_run(strict_p)
    for a, kw, out in nodes.calls:
        spec, feat, f_count, n_nodes, dev = a
        cpu = grow_module.make_node_samplers(
            spec, {"ff_key": feat["ff_key"], "nb": feat["nb"].cpu()},
            f_count, n_nodes, "cpu")
        _check(torch.equal(out.bynode.cpu(), cpu.bynode)
               and torch.equal(out.pick.cpu(), cpu.pick),
               "train_sampled nodes: a tree's node masks != the CPU's")
    _check(len(nodes.calls) == NODE_ROUNDS and nc["threefry"] == 2 *
           NODE_ROUNDS, f"train_sampled nodes: {len(nodes.calls)} trees "
           f"drew, {nc['threefry']} threefry launches")
    for name, c in (("sampled", nc), ("unsampled", pc)):
        # one sync for the root and one per split, with or without sampling
        _check(c["syncs"] == c["trees"] + c["splits"],
               f"train_sampled nodes: the {name} run counted {c}")
    _check(lt.train(node_p, data.dataset, num_boost_round=NODE_ROUNDS)
           .model_to_string() == nbst.model_to_string(),
           "train_sampled nodes: two runs differ")
    raw = nbst.predict(data.X_hold, raw_score=True)
    _check(bool(np.all(np.isfinite(raw))),
           "train_sampled nodes: scores not finite")
    report["nodes"] = {
        "params": NODE_PARAMS, "rounds": NODE_ROUNDS,
        "node_ids_a_tree": nodes.calls[0][0][3],
        "leaves_per_tree": [t.num_leaves for t in nbst.trees],
        "masks_bitwise_cpu": len(nodes.calls),
        "host_syncs_per_tree": nc["syncs"] / nc["trees"],
        "unsampled_host_syncs_per_tree": pc["syncs"] / pc["trees"],
        "unsampled_leaves_per_tree": [t.num_leaves
                                      for t in plain_bst.trees],
        "threefry_launches": nc["threefry"], "auc": _auc(raw, data.y_hold),
        "model_text_identical_twice": True}
    if timing:
        report["nodes"].update(round_ms=nc["round_ms"],
                               unsampled_round_ms=pc["round_ms"])
    _emit(report)
    return launches


# ------------------------------------------------------- categorical
#: the categorical phase's problem: the repo's `categorical_efb` family
#: (`benchmarks/bench_families.py:12`, `:70 make_criteo_like`, `:130`) as
#: it runs by default: 500,000 training rows and 50,000 held out (`:37`,
#: `:105`), binary, 31 leaves, max_bin 255, learning rate 0.1 and the
#: bench's wave settings (`benchmarks/configs_r4.py` SHIPPED, as `:47`
#: reads them: WAVE_PARAMS), 10 rounds
CAT_ROWS = 500_000
CAT_HOLD = 50_000
CAT_PARAMS = dict(WAVE_PARAMS)
CAT_QUANT = dict(CAT_PARAMS, **QUANT)
#: the strict run: 255 leaves, 3 rounds (K1 at S = 1, 255 launches a tree)
CAT_STRICT = dict(TRAIN_PARAMS)
CAT_STRICT_ROUNDS = 3
#: the cardinalities of `make_criteo_like`'s 26 categorical columns; those
#: of at most CAT_ONEHOT_MAX levels are one-hot encoded in the bundled run
CRITEO_CARDS = [3, 4, 8, 12, 16, 24, 32, 50, 64, 100, 120, 200, 300, 400,
                500, 700, 1000, 1500, 2000, 3000, 4000, 6000, 8000, 10000,
                40, 80]
CAT_ONEHOT_MAX = 40
#: the wide-bitset case: one categorical column whose levels are the top
#: 16 of the family's 10,000 (9984 .. 9999, bitset word 312), so every
#: split on it stores a bitset of 313 words, the widest the family's
#: categoricals can need; trained and served on the card
WIDE_LEVELS = np.arange(9984, 10000)
WIDE_ROWS = 50_000
WIDE_ROUNDS = 3


def make_criteo_like(n_rows, seed=11):
    """13 numeric + 26 categorical columns, a few of up to 10,000 levels:
    the generator of the repo's `categorical_efb` family
    (`benchmarks/bench_families.py:70 make_criteo_like`), copied so this
    script imports nothing of that package."""
    rng = np.random.RandomState(seed)
    num = rng.lognormal(0.0, 1.0, (n_rows, 13)).astype(np.float32)
    cats = np.stack([rng.randint(0, c, n_rows) for c in CRITEO_CARDS],
                    axis=1).astype(np.float32)
    w = rng.randn(13) * 0.4
    score = num @ w
    for j, c in ((0, 3), (5, 24), (17, 1500)):
        eff = rng.randn(c) * 0.5
        score = score + eff[cats[:, j].astype(np.int64)]
    y = (score + rng.randn(n_rows) > np.median(score)).astype(np.float64)
    X = np.concatenate([num, cats], axis=1)
    return X, y, list(range(13, 39))


def criteo_onehot(X):
    """X with each categorical column of at most CAT_ONEHOT_MAX levels
    replaced, in place, by its one-hot block of 0/1 numerical columns
    (8 columns -> 139, 170 in all); returns (X, the categorical columns
    left)."""
    cols, cat_idx = [X[:, :13]], []
    at = 13
    for j, card in enumerate(CRITEO_CARDS):
        v = X[:, 13 + j]
        if card <= CAT_ONEHOT_MAX:
            block = (v[:, None] == np.arange(card)[None, :])
            cols.append(block.astype(np.float32))
            at += card
        else:
            cols.append(v[:, None])
            cat_idx.append(at)
            at += 1
    return np.concatenate(cols, axis=1), cat_idx


class CatData:
    """The categorical phase's data, binned once on the host: (a) the 39
    columns as published, 26 categorical; (b) the one-hot variant, which
    EFB bundles."""

    def __init__(self, seed: int, n_train: int = CAT_ROWS,
                 n_hold: int = CAT_HOLD):
        import lightgbm_tpu_torch as lt
        t_setup = time.perf_counter()
        X, y, cat_idx = make_criteo_like(n_train + n_hold, seed=11 + seed)
        self.y, self.y_hold = y[:n_train], y[n_train:]
        self.X_hold = X[n_train:]
        t0 = time.perf_counter()
        self.dataset = lt.Dataset(X[:n_train], label=self.y,
                                  categorical_feature=cat_idx,
                                  params=dict(CAT_PARAMS)).construct()
        self.binning_s = time.perf_counter() - t0
        Xo, cat_o = criteo_onehot(X)
        self.X_hold_onehot = Xo[n_train:]
        t0 = time.perf_counter()
        self.onehot = lt.Dataset(Xo[:n_train], label=self.y,
                                 categorical_feature=cat_o,
                                 params=dict(CAT_PARAMS)).construct()
        self.onehot_binning_s = time.perf_counter() - t0
        # generation, one-hot encoding and both binnings
        self.setup_s = time.perf_counter() - t_setup


def _cat_split_cases(trees, ds, max_cat_to_onehot):
    """(one-vs-rest, sorted) counts of the categorical splits of `trees`,
    by the case the search took: the trees are replayed on the training
    bins, and a split whose feature has at most `max_cat_to_onehot` used
    bins (>= 1, holding rows) at its node is one-vs-rest (case 2)."""
    bins = ds.bin_data
    nb = [m.num_bin for m in ds.bin_mappers]
    missing = [m.missing_type for m in ds.bin_mappers]
    ovr = srt = 0
    for t in trees:
        node = np.zeros(bins.shape[0], np.int64)
        for i in range(t.num_leaves - 1):
            rows = np.nonzero(node == i)[0]
            f = int(t.split_feature[i])
            b = bins[rows, f].astype(np.int64)
            if t.decision_type[i] & 1:
                used = np.count_nonzero(np.bincount(b, minlength=nb[f])[1:])
                ovr += used <= max_cat_to_onehot
                srt += used > max_cat_to_onehot
                left = t.cat_bin_masks[int(t.threshold_bin[i])][b]
            else:
                left = b <= t.threshold_bin[i]
                if missing[f] == 2:
                    left = np.where(b == nb[f] - 1,
                                    bool(t.decision_type[i] & 2), left)
            node[rows] = np.where(left, t.left_child[i], t.right_child[i])
    return int(ovr), int(srt)


def _served_bitwise(bst, X, device, name):
    """The model served by ServingRuntime on `device`, bitwise the host
    walk at f32 thresholds (`f32_threshold_walk`); returns the runtime's
    record bytes and largest bitset in words."""
    import lightgbm_tpu_torch as lt
    rt = lt.ServingRuntime(bst, device=device)
    raw = rt.predict(X, raw_score=True)
    _check(_bits_equal(raw, f32_threshold_walk(bst, X)),
           f"train_categorical {name}: served scores != the host walk")
    rec = rt._state.records
    return {"record_bytes": int(rec.nodes.numel() * 4),
            "bitset_bytes": int(rec.catw.numel() * 4)
            if rec.catw is not None else 0, "bitset_words": int(rec.mw)}


def _wide_bitset_served(params, device, seed: int):
    """A model whose categorical splits all hold bitsets of 313 words
    (the column's levels are WIDE_LEVELS), trained with `params` and
    served by ServingRuntime on `device` bitwise the host walk on
    held-out rows that also carry NaN, negative, unseen and out-of-range
    categories; returns `_served_bitwise`'s record sizes and the
    model's categorical splits."""
    import lightgbm_tpu_torch as lt
    rng = np.random.RandomState(seed + 23)
    n, n_hold = WIDE_ROWS, WIDE_ROWS // 10
    level = rng.randint(0, len(WIDE_LEVELS), n + n_hold)
    x0 = rng.randn(n + n_hold)
    score = rng.randn(len(WIDE_LEVELS))[level] + 0.5 * x0
    y = (score + rng.randn(n + n_hold) > 0).astype(np.float64)
    X = np.stack([x0, WIDE_LEVELS[level].astype(np.float64)], axis=1)
    hold = X[n:].copy()
    for k, v in enumerate((np.nan, -3.0, 5.0, 9983.0, 12000.0)):
        hold[k::7, 1] = v
    bst = lt.train(params, lt.Dataset(X[:n], label=y[:n],
                                      categorical_feature=[1]),
                   num_boost_round=WIDE_ROUNDS)
    served = _served_bitwise(bst, hold, device, "wide bitset")
    n_cat = sum(t.num_cat for t in bst.trees)
    _check(n_cat > 0 and served["bitset_words"] == 313,
           f"train_categorical wide bitset: {n_cat} categorical splits, "
           f"{served}")
    return dict(served, categorical_splits=int(n_cat),
                levels=[int(WIDE_LEVELS[0]), int(WIDE_LEVELS[-1])],
                rows=n, held_out=n_hold, rounds=WIDE_ROUNDS)


def phase_train_categorical(cd: CatData, modules, device=None,
                            timing: bool = True,
                            rounds: int = TRAIN_ROUNDS):
    """`lightgbm_tpu_torch.train` on the `categorical_efb` family.

    (a) The 39 columns, 26 categorical: the fused wave (K2/K3, the main
    run, between its own counter reads) timed, with per round K2
    launches = 1 + waves that built histograms, K3 launches = those
    waves, host syncs = 1 + those waves (the categorical features add no
    launch of either); a second fused run and an unfused run (K1 and the
    torch search) byte-identical to it; the held-out AUC within 1e-3 of
    `hist_impl=segment_sum`; a quantized run (K5/K3) within 0.02 of it;
    a strict run at 255 leaves, 3 rounds, K1 launches = 255 a round; the
    f32 model served on the card bitwise the host walk; the categorical
    splits counted by case and the largest bitset; a model whose bitsets
    are 313 words (`_wide_bitset_served`) served bitwise the host
    walk.  (b) The one-hot variant, 170 columns that EFB bundles: the
    wave unfused on K1 over the bundle columns, two runs byte-identical;
    quantized on K4; the held-out AUC within 1e-3 of the same bins
    unbundled; served bitwise the host walk.  Then round times, the
    categorical search's share (CUDA events around its calls), one
    profiled round of (a), and the phase's wall seconds (`phase_s`;
    `phase_with_setup_s` adds `cd.setup_s`, the data's generation and
    binning).  Returns the phase's report."""
    import copy
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import grow as grow_module
    from lightgbm_tpu_torch.ops import grow_wave
    t_phase = time.perf_counter()
    params, quant, strict = (dict(CAT_PARAMS), dict(CAT_QUANT),
                             dict(CAT_STRICT))
    if device is not None:
        for p in (params, quant, strict):
            p["device_type"] = device
    hold = cd.X_hold

    # ---- (a) the main path, alone between the counter reads
    _zero_quant_counters(modules)
    t0 = time.perf_counter()
    bst, rec = _wave_run(params, cd.dataset, modules, rounds, timing,
                         patch=[(grow_wave, "fused_hist_split"),
                                (grow_wave, "split_scan"),
                                (grow_wave, "find_best_split")],
                         counters=_quant_counters)
    train_s = time.perf_counter() - t0
    total = _quant_counters(modules)
    spec = bst._grower_spec
    _check(spec.fused and spec.has_cat and not spec.bundled,
           f"train_categorical: the run is not fused on categoricals "
           f"({spec.fused}, {spec.has_cat}, {spec.bundled})")
    for r, c in enumerate(rec["per_round"]):
        _check(c["k2"] == 1 + c["hist_waves"] and c["k3"] == c["hist_waves"]
               and c["syncs"] == 1 + c["hist_waves"] and c["k1"] == 0
               and c["k4"] == 0 and c["k5"] == 0 and c["hist_waves"] > 0,
               f"train_categorical: round {r + 1} counted {c}")
    _check(len(bst.trees) == rounds, "train_categorical: bad model")
    text = bst.model_to_string()
    _check(lt.train(params, cd.dataset, num_boost_round=rounds)
           .model_to_string() == text,
           "train_categorical: two fused runs differ")
    _zero_quant_counters(modules)
    unfused = lt.train(dict(params, tpu_fused_split=False), cd.dataset,
                       num_boost_round=rounds)
    uc = _quant_counters(modules)
    _check(not unfused._grower_spec.fused and uc["k2"] == 0
           and uc["k3"] == 0 and uc["k1"] == rounds + uc["hist_waves"],
           f"train_categorical: the unfused run counted {uc}")
    _check(_without(unfused.model_to_string(), "tpu_fused_split")
           == _without(text, "tpu_fused_split"),
           "train_categorical: fused and unfused models differ")
    seg = lt.train(dict(params, hist_impl="segment_sum"), cd.dataset,
                   num_boost_round=rounds)
    raw = bst.predict(hold, raw_score=True)
    _check(bool(np.all(np.isfinite(raw))),
           "train_categorical: scores not finite")
    auc_k = _auc(raw, cd.y_hold)
    auc_s = _auc(seg.predict(hold, raw_score=True), cd.y_hold)
    _check(abs(auc_k - auc_s) <= 1e-3,
           f"train_categorical: held-out AUC {auc_k} vs segment_sum {auc_s}")
    served = _served_bitwise(bst, hold, device, "f32")
    ovr, srt = _cat_split_cases(bst.trees, cd.dataset,
                                bst.config.max_cat_to_onehot)
    cat_splits = sum(int(np.sum(t.decision_type[:t.num_leaves - 1] & 1))
                     for t in bst.trees)
    _check(cat_splits == ovr + srt and cat_splits > 0,
           f"train_categorical: {cat_splits} categorical splits, "
           f"{ovr} + {srt} by case")
    max_words = max((int(np.diff(t.cat_boundaries).max())
                     for t in bst.trees if t.num_cat), default=0)

    _zero_quant_counters(modules)
    qbst, qrec = _wave_run(quant, cd.dataset, modules, rounds, False,
                           counters=_quant_counters)
    qc = _quant_counters(modules)
    _check(qbst._grower_spec.fused and qbst.hist_impl == "kernel_q",
           "train_categorical: the quantized run is not fused on K5")
    for r, c in enumerate(qrec["per_round"]):
        _check(c["k5"] == 1 + c["hist_waves"] and c["k3"] == c["hist_waves"]
               and c["k2"] == 0 and c["k1"] == 0 and c["k4"] == 0,
               f"train_categorical quant: round {r + 1} counted {c}")
    auc_q = _auc(qbst.predict(hold, raw_score=True), cd.y_hold)
    _check(abs(auc_q - auc_k) <= 0.02,
           f"train_categorical: quantized AUC {auc_q} vs f32 {auc_k}")

    _zero_quant_counters(modules)
    marks = []

    def mark(env):
        if timing:
            torch.cuda.synchronize()
        marks.append(time.perf_counter())
    t0 = time.perf_counter()
    sbst = lt.train(strict, cd.dataset, num_boost_round=CAT_STRICT_ROUNDS,
                    callbacks=[mark])
    sc = _quant_counters(modules)
    leaves = [t.num_leaves for t in sbst.trees]
    _check(sc["k1"] == sum(leaves) == 255 * CAT_STRICT_ROUNDS
           and sc["syncs"] == sum(leaves) and sc["k2"] == 0,
           f"train_categorical strict: {sc} for leaves {leaves}")
    auc_strict = _auc(sbst.predict(hold, raw_score=True), cd.y_hold)
    # the deeper trees split the wide categoricals: larger bitsets served
    served_strict = _served_bitwise(sbst, hold, device, "strict")
    wide = _wide_bitset_served(params, device, 0)

    # ---- (b) the one-hot variant, bundled
    ds = cd.onehot
    efb = ds.efb
    _check(efb is not None and len(efb.bundles) > 0,
           "train_categorical: EFB found no bundle in the one-hot variant")
    _zero_quant_counters(modules)
    bbst, brec = _wave_run(params, ds, modules, rounds, timing,
                           patch=[(grow_module, "histogram_multi")],
                           counters=_quant_counters)
    bc = _quant_counters(modules)
    bspec = bbst._grower_spec
    _check(bspec.bundled and not bspec.fused
           and bspec.bundle_max_bin == efb.max_bin,
           f"train_categorical bundled: spec {bspec}")
    for r, c in enumerate(brec["per_round"]):
        _check(c["k1"] == 1 + c["hist_waves"] and c["k2"] == 0
               and c["k3"] == 0 and c["syncs"] == 1 + c["hist_waves"],
               f"train_categorical bundled: round {r + 1} counted {c}")
    btext = bbst.model_to_string()
    _check(lt.train(params, ds, num_boost_round=rounds).model_to_string()
           == btext, "train_categorical bundled: two runs differ")
    _zero_quant_counters(modules)
    bq = lt.train(quant, ds, num_boost_round=rounds)
    bqc = _quant_counters(modules)
    _check(bq._grower_spec.bundled and bqc["k4"] == rounds
           + bqc["hist_waves"] and bqc["k5"] == 0 and bqc["k1"] == 0,
           f"train_categorical bundled quant: counted {bqc}")
    # the same bins without the bundles: what enable_bundle=False
    # constructs (the bundle search runs after binning)
    plain = copy.copy(ds)
    plain.efb, plain.bundle_data = None, None
    ub = lt.train(dict(params, enable_bundle=False), plain,
                  num_boost_round=rounds)
    _check(ub._dd.efb is None, "train_categorical: the unbundled run bundled")
    hold_o = cd.X_hold_onehot
    auc_b = _auc(bbst.predict(hold_o, raw_score=True), cd.y_hold)
    auc_u = _auc(ub.predict(hold_o, raw_score=True), cd.y_hold)
    auc_bq = _auc(bq.predict(hold_o, raw_score=True), cd.y_hold)
    _check(abs(auc_b - auc_u) <= 1e-3,
           f"train_categorical: bundled AUC {auc_b} vs unbundled {auc_u}")
    _check(abs(auc_bq - auc_b) <= 0.02,
           f"train_categorical: bundled quantized AUC {auc_bq} vs {auc_b}")
    served_b = _served_bitwise(bbst, hold_o, device, "bundled")
    # splits on the features EFB bundled: their partition decodes the
    # bundle columns
    members = sorted({f for b in efb.bundles for f in b})
    member_splits = int(bbst.feature_importance()[members].sum())
    _check(member_splits > 0,
           "train_categorical bundled: no split on a bundled feature")

    report = {
        "phase": "train_categorical", "params": CAT_PARAMS,
        "rows": int(cd.dataset.num_data()), "held_out": int(len(hold)),
        "rounds": rounds, "binning_s": cd.binning_s,
        "categorical": {
            "features": int(cd.dataset.num_feature()),
            "categorical_features": int(sum(
                m.bin_type == 1 for m in cd.dataset.bin_mappers)),
            "max_bin": int(bst._dd.max_bin),
            "leaves_per_tree": [t.num_leaves for t in bst.trees],
            "categorical_splits": cat_splits,
            "one_vs_rest_splits": ovr, "sorted_splits": srt,
            "largest_bitset_words": max_words,
            "served": served, "served_bitwise_host_walk": True,
            "auc_fused": auc_k, "auc_segment_sum": auc_s,
            "auc_quantized": auc_q, "auc_strict_255": auc_strict,
            "model_text_identical_fused_twice": True,
            "model_text_identical_unfused": True,
            "waves": total["waves"], "hist_waves": total["hist_waves"],
            "host_syncs": total["syncs"],
            "per_round_counts": rec["per_round"],
            "launches": {"fused_hist_split": total["k2"],
                         "split_scan": total["k3"],
                         "unfused_histogram": uc["k1"],
                         "quant_fused_hist_split_q": qc["k5"],
                         "quant_split_scan": qc["k3"],
                         "strict_histogram": sc["k1"]},
            "strict_leaves_per_tree": leaves, "strict_served": served_strict,
            "strict_categorical_splits": sum(t.num_cat for t in sbst.trees),
            "wide_bitset": wide, "train_s": train_s},
        "bundled": {
            "binning_s": cd.onehot_binning_s,
            "features": int(ds.num_feature()), "columns": int(efb.n_cols),
            "bundle_max_bin": int(efb.max_bin),
            "bundles": [list(b) for b in efb.bundles],
            "leaves_per_tree": [t.num_leaves for t in bbst.trees],
            "bundled_feature_splits": member_splits,
            "auc": auc_b, "auc_unbundled": auc_u, "auc_quantized": auc_bq,
            "model_text_identical_twice": True, "served": served_b,
            "served_bitwise_host_walk": True,
            "per_round_counts": brec["per_round"],
            "launches": {"histogram": bc["k1"], "quant_histogram_q":
                         bqc["k4"]}}}
    if timing:
        steady = rec["round_s"][1:]
        search = rec["find_best_split_ms_per_round"]
        k2 = rec["fused_hist_split_ms_per_round"]
        report["categorical"].update({
            "round_ms": [float(x) * 1e3 for x in rec["round_s"]],
            "ms_per_round_2_to_10": float(steady.mean()) * 1e3,
            "cat_search_ms_per_round": [float(x) for x in search],
            "cat_search_share_2_to_10": float(
                search[1:].sum() / (steady.sum() * 1e3)),
            "k2_share_2_to_10": float(k2[1:].sum() / (steady.sum() * 1e3)),
            "strict_round_ms": [float(x) * 1e3
                                for x in np.diff([t0] + marks)],
            "profiled_round": _profile_round(params, cd.dataset)})
        bsteady = brec["round_s"][1:]
        k1 = brec["histogram_multi_ms_per_round"]
        report["bundled"].update({
            "round_ms": [float(x) * 1e3 for x in brec["round_s"]],
            "ms_per_round_2_to_10": float(bsteady.mean()) * 1e3,
            "k1_share_2_to_10": float(k1[1:].sum() / (bsteady.sum() * 1e3))})
    report["phase_s"] = time.perf_counter() - t_phase
    report["phase_with_setup_s"] = report["phase_s"] + cd.setup_s
    report["setup_s"] = cd.setup_s
    _emit(report)
    return report


def _import_port(root: str, name: str, *modules):
    """The named modules (e.g. "ops.hist_kernel") of the port package in
    another checkout at `root`, imported as package `name` beside this
    one (its kernels build under that checkout)."""
    import importlib
    import importlib.util
    if name not in sys.modules:
        pkg = os.path.join(os.path.abspath(root), "lightgbm_tpu_torch")
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(pkg, "__init__.py"),
            submodule_search_locations=[pkg])
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return tuple(importlib.import_module(f"{name}.{m}") for m in modules)


def _turns(this, base, timing=True, flush=None):
    """`this` and `base` timed in turns (this, base, base, this) at the
    host's pace (`ms`) and as device time, their launches queued behind
    a spin kernel (`device_ms`); with `flush`, also as device time with
    the L2 flushed before each run (`cold_device_ms`); the means of
    each."""
    out = {}
    if not timing:
        return out
    runs = [("ms", False, None), ("device_ms", True, None)]
    if flush is not None:
        runs.append(("cold_device_ms", True, flush))
    for key, queued, fl in runs:
        t = [_cuda_ms(f, queued=queued, flush=fl)
             for f in (this, base, base, this)]
        out[key] = (t[0] + t[3]) / 2
        out["baseline_" + key] = (t[1] + t[2]) / 2
    return out


def phase_compare_serving(seed: int, baseline: str, device=None,
                          timing: bool = True):
    """The serving kernels of this checkout against those of the
    checkout at `baseline`, on the main phase's model and requests at
    TIMED_ROWS rows: the standalone traverse (every depth bucket)
    bitwise the baseline's, the standalone sum bitwise on the same
    slots, this checkout's request program (the fused entry) bitwise
    the baseline's `compiled_predict`, the stacked traversal (kernel A)
    and the bounded sum (kernel B) bitwise the baseline's on the same
    inputs; each timed in turns (A and B also L2-flushed).  Then a
    whole converted request through each checkout's `ServingRuntime`
    (its own `Booster`) on the compiled, device_sum and bounded rungs,
    bitwise, its host-clock p50 in turns (`_request_turns`)."""
    import torch
    from lightgbm_tpu_torch import Booster, ServingRuntime
    from lightgbm_tpu_torch.compiler import kernel
    from lightgbm_tpu_torch.ops import predict
    t_phase = time.perf_counter()
    base_kernel, base_predict = _import_port(
        baseline, "baseline_port", "compiler.kernel", "ops.predict")
    rt = ServingRuntime(Booster(model_str=synthetic_forest_text(seed)),
                        device=device)
    st = rt._state
    ex = st.export
    vals = ex["value_f64"]
    X = request_rows(np.random.RandomState(seed + 1), max(TIMED_ROWS))
    report = {"phase": "compare_serving", "baseline": baseline}
    for b in TIMED_ROWS:
        Xd = rt._stage32(X[:b], b)
        new_s = torch.cat(_traverse(rt, Xd, kernel.traverse_bucket))
        old_s = torch.cat(_traverse(rt, Xd, base_kernel.traverse_bucket))
        _check(torch.equal(new_s, old_s),
               f"compare: {b} rows: K6 of this checkout and the baseline "
               f"differ")
        new_a = predict.accumulate_slots_exact(new_s, st.gidx, vals, 1)
        old_a = base_predict.accumulate_slots_exact(new_s, st.gidx, vals, 1)
        new_r = _serve(rt, Xd)
        old_r = base_kernel.compiled_predict(Xd, st.planes, st.gidx, vals,
                                             meta=st.meta)
        _check(_bits_equal(new_a.cpu().numpy(), old_a.cpu().numpy())
               and _bits_equal(new_r.cpu().numpy(), old_r.cpu().numpy()),
               f"compare: {b} rows: the sums of this checkout and the "
               f"baseline differ")
        report[str(b)] = {
            "traverse": _turns(
                lambda: _traverse(rt, Xd, kernel.traverse_bucket),
                lambda: _traverse(rt, Xd, base_kernel.traverse_bucket),
                timing),
            "accumulate": _turns(
                lambda: predict.accumulate_slots_exact(new_s, st.gidx,
                                                       vals, 1),
                lambda: base_predict.accumulate_slots_exact(new_s, st.gidx,
                                                            vals, 1),
                timing),
            "request_program": _turns(
                lambda: _serve(rt, Xd),
                lambda: base_kernel.compiled_predict(
                    Xd, st.planes, st.gidx, vals, meta=st.meta), timing)}
    # kernels A and B (the stacked traversal, the bounded sum) of both
    # checkouts on the same inputs: bitwise, timed in turns
    ex_dev = rt._booster.export_predict_arrays(device=rt.device)
    stacked = predict.with_records(ex_dev["stacked"])
    b_rt = ServingRuntime(rt._booster, device=device, precision="bounded")
    bd = b_rt._state.dev
    flush = _flusher(rt.device) if timing else None
    for b in TIMED_ROWS:
        Xd = rt._stage32(X[:b], b)
        new_a = predict.predict_leaf_ensemble(stacked, Xd)
        old_a = base_predict.predict_leaf_ensemble(stacked, Xd)
        _check(torch.equal(new_a, old_a),
               f"compare: {b} rows: kernel A of this checkout and the "
               "baseline differ")
        Xb = b_rt._stage32(X[:b], b_rt._chunk_rows(b))
        slots = kernel.traverse_all(Xb, bd.planes, b_rt._state.meta)
        args = (slots, bd.qval, bd.tile, bd.scales, 1)
        new_b = predict.accumulate_slots_bounded(
            *args, gather_idx=bd.gidx, groups=bd.groups)
        old_b = base_predict.accumulate_slots_bounded(
            *args, gather_idx=bd.gidx, groups=bd.groups)
        _check(_bits_equal(new_b.cpu().numpy(), old_b.cpu().numpy()),
               f"compare: {b} rows: kernel B of this checkout and the "
               "baseline differ")
        report[str(b)]["stacked_slots"] = _turns(
            lambda: predict.predict_leaf_ensemble(stacked, Xd),
            lambda: base_predict.predict_leaf_ensemble(stacked, Xd), timing,
            flush)
        report[str(b)]["accumulate_bounded"] = _turns(
            lambda: predict.accumulate_slots_bounded(
                *args, gather_idx=bd.gidx, groups=bd.groups),
            lambda: base_predict.accumulate_slots_bounded(
                *args, gather_idx=bd.gidx, groups=bd.groups), timing, flush)
    del flush
    base_booster, base_runtime = _import_port(
        baseline, "baseline_port", "booster", "serving.runtime")
    text = synthetic_forest_text(seed)
    # each checkout's whole request, on the compiled rung and on the two
    # rungs kernels A and B serve
    for label, opts in (("runtime_p50_ms", {}),
                        ("device_sum_p50_ms", {"compiled": "off"}),
                        ("bounded_p50_ms", {"precision": "bounded"})):
        this_rt = rt if not opts else ServingRuntime(
            Booster(model_str=text), device=device, **opts)
        base_rt = base_runtime.ServingRuntime(
            base_booster.Booster(model_str=text), device=device, **opts)
        _check(this_rt.rung == base_rt.rung,
               f"compare: {label}: rungs {this_rt.rung} and {base_rt.rung}")
        for b in TIMED_ROWS:
            _check(_bits_equal(this_rt.predict(X[:b]),
                               base_rt.predict(X[:b])),
                   f"compare: {b} rows: the {this_rt.rung} runtimes' "
                   "answers differ")
            report[str(b)][label] = _request_turns(
                lambda: this_rt.predict(X[:b]),
                lambda: base_rt.predict(X[:b]), timing)
    # each checkout's device_predict: a whole raw request, then the
    # device program alone over each checkout's own state
    from lightgbm_tpu_torch.booster import stage_rows
    this_b, base_b = Booster(model_str=text), base_booster.Booster(
        model_str=text)
    dev = rt.device
    t_st = this_b._device_predict_state(0, None, dev)
    b_st = base_b._device_predict_state(0, None, dev)
    Xp = request_rows(np.random.RandomState(seed + 2), PREDICT_F32_ROWS)
    flush = _flusher(dev) if timing else None
    dp = {}
    for b in TIMED_ROWS + (PREDICT_F32_ROWS,):
        Xd = stage_rows(Xp[:b], dev)

        def this_prog(Xd=Xd):
            return kernel.serve_forest_f32(Xd, t_st.records, t_st.values)

        def base_prog(Xd=Xd):
            return base_kernel.predict_raw_f32(
                Xd, b_st.planes, b_st.gidx, b_st.values, meta=b_st.meta)

        _check(_bits_equal(this_prog().cpu().numpy(),
                           base_prog().cpu().numpy()),
               f"compare: {b} rows: the device_predict programs differ")
        dp[str(b)] = {"program": _turns(this_prog, base_prog, timing,
                                        flush)}
        if b in TIMED_ROWS:
            def this_req(b=b):
                return this_b.predict(Xp[:b], raw_score=True,
                                      device_predict=True,
                                      device_type=dev.type)

            def base_req(b=b):
                return base_b.predict(Xp[:b], raw_score=True,
                                      device_predict=True,
                                      device_type=dev.type)

            _check(_bits_equal(this_req(), base_req()),
                   f"compare: {b} rows: the device_predict answers differ")
            dp[str(b)]["request_p50_ms"] = _request_turns(this_req,
                                                          base_req, timing)
    del flush
    report["device_predict"] = dp
    report["phase_s"] = time.perf_counter() - t_phase
    _emit(report)
    return report


def _request_turns(this, base, timing=True, repeats=30):
    """Host-clock p50 (ms) of `this` and `base`, each a synchronised
    request, in turns (this, base, base, this) of `repeats` runs."""
    import torch
    if not timing:
        return {}
    runs = {0: [], 1: []}
    for side in (0, 1, 1, 0):
        fn = (this, base)[side]
        fn()
        for _ in range(repeats):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            runs[side].append(time.perf_counter() - t)
    return {"ms": float(np.median(runs[0])) * 1e3,
            "baseline_ms": float(np.median(runs[1])) * 1e3}


def phase_compare(data: TrainData, seed: int, baseline: str, device=None,
                  u16_rows: int = 100_000, timing: bool = True):
    """K1 and K2 of this checkout against those of the checkout at
    `baseline`, on the histogram and fused phases' inputs: the two agree
    within twice the contract's tolerance (each is within it of the plain
    version), counts exact; K3 on K1's histograms at S = 1, 8, 14, 42 and
    u16, K4 and K5 on the quantized phases' inputs, and the link kernel
    (exp and sigmoid), bitwise (their contract); each timed in turns
    (this, baseline, baseline, this), at the host's pace (`ms`) and as
    device time, its launches queued behind a spin kernel (`device_ms`),
    the link also with L2 flushed before each launch; both carries
    (`_compare_carries`)."""
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import fused_kernel as fk
    from lightgbm_tpu_torch.ops import hist_kernel as hk
    from lightgbm_tpu_torch.ops import hist_kernel_q as hq
    from lightgbm_tpu_torch.ops import xla_math
    base_hk, base_fk, base_hq, base_xm = _import_port(
        baseline, "baseline_port", "ops.hist_kernel", "ops.fused_kernel",
        "ops.hist_kernel_q", "ops.xla_math")
    dev = torch.device(device or "cuda")
    ds = data.dataset
    wide = lt.Dataset(data.X[:u16_rows], label=data.y[:u16_rows],
                      params={"max_bin": 1023, "verbosity": -1}).construct()
    bins_main = np.ascontiguousarray(ds.bin_data.T)
    bins_wide = np.ascontiguousarray(wide.bin_data.T)
    mb = max(m.num_bin for m in ds.bin_mappers)
    mb_w = max(m.num_bin for m in wide.bin_mappers)
    report = {"phase": "compare", "baseline": baseline, "k1": {}, "k2": {},
              "k3": {}, "k4": {}, "k5": {}}

    def agree(name, new, old, b, p, l, s, m):
        absum = _hist14(hk.histogram_multi_plain, b, p.abs(), l, s, m)
        _check(torch.equal(new[..., 2], old[..., 2])
               and bool(((new - old).abs() <= 2e-4 * absum + 2e-6).all()),
               f"compare {name}: this checkout and the baseline disagree")

    def turns(this, base):
        return _turns(this, base, timing)

    for name, bnp, y, frac, slots, m in (
            ("root", bins_main, data.y, 1.0, [0], mb),
            ("leaf_1pct", bins_main, data.y, 0.01, [0], mb),
            ("slots_14", bins_main, data.y, 0.0,
             list(range(12)) + [300, 301], mb),
            ("u16_1023", bins_wide, data.y[:u16_rows], 1.0, [0], mb_w)):
        b, p, l, s = _hist_inputs(bnp, y, frac, slots, seed, dev)
        agree(name, hk.histogram_multi(b, p, l, s, m),
              base_hk.histogram_multi(b, p, l, s, m), b, p, l, s, m)
        report["k1"][name] = turns(
            lambda: hk.histogram_multi(b, p, l, s, m),
            lambda: base_hk.histogram_multi(b, p, l, s, m))
    kw = FUSED_SCAN_KW
    lid3 = _partition(bins_main, 3)
    for name, d, bnp, y, lid_np, slots in (
            ("root_s1", ds, bins_main, data.y, np.zeros_like(lid3), [0]),
            ("leaf_s1", ds, bins_main, data.y, _partition(bins_main, 5),
             [0]),
            ("s8", ds, bins_main, data.y, lid3, list(range(7)) + [99]),
            ("s14", ds, bins_main, data.y, _partition(bins_main, 4),
             list(range(13)) + [99]),
            ("s42", ds, bins_main, data.y, _partition(bins_main, 6),
             list(range(42))),
            ("u16_1023_s4", wide, bins_wide, data.y[:u16_rows],
             _partition(bins_wide, 2), [0, 1, 2, 3])):
        m = max(x.num_bin for x in d.bin_mappers)
        f = bnp.shape[0]
        nb = torch.tensor([x.num_bin for x in d.bin_mappers],
                          dtype=torch.int32, device=dev)
        miss = torch.arange(f, dtype=torch.int32, device=dev) % 3
        b = torch.from_numpy(bnp).to(dev)
        p = torch.from_numpy(_wave_payload(y, seed)).to(dev)
        l = torch.from_numpy(lid_np).to(dev)
        s = torch.tensor(slots, dtype=torch.int32, device=dev)
        h = _hist14(hk.histogram_multi, b, p, l, s, m)
        parent = h[:, 0].sum(dim=1)
        parent = parent.contiguous()
        args = (b, p, l, s, nb, miss, parent, m)
        agree(name, fk.fused_hist_split(*args, **kw)[0],
              base_fk.fused_hist_split(*args, **kw)[0], b, p, l, s, m)
        report["k2"][name] = turns(
            lambda: fk.fused_hist_split(*args, **kw),
            lambda: base_fk.fused_hist_split(*args, **kw))
        # K3 (and so K2's scan) on K1's histogram: bitwise, its contract
        sc = (h, nb, miss, parent)
        _check(_bits_equal(fk.split_scan(*sc, **kw).cpu().numpy(),
                           base_fk.split_scan(*sc, **kw).cpu().numpy()),
               f"compare {name}: K3 of this checkout and the baseline "
               "differ")
        report["k3"][name] = dict(turns(
            lambda: fk.split_scan(*sc, **kw),
            lambda: base_fk.split_scan(*sc, **kw)), slots=len(slots))
    for name, d, bnp, y, lid_np, slots in _quant_cases(data, u16_rows, seed):
        m = max(x.num_bin for x in d.bin_mappers)
        f = bnp.shape[0]
        inp = _quant_inputs(bnp, y, lid_np, slots, seed, dev)
        q = (inp["bins"], inp["pw3"], inp["lid"], inp["sl"])
        sc = (inp["sg"], inp["sh"])
        new4 = hq.histogram_multi_quantized(*q, m, *sc)
        old4 = base_hq.histogram_multi_quantized(*q, m, *sc)
        _check(_bits_equal(new4.cpu().numpy(), old4.cpu().numpy()),
               f"compare {name}: K4 of this checkout and the baseline differ")
        rows_in = int((inp["lid"][:, None] == inp["sl"][None, :]).any(1)
                      .sum())
        report["k4"][name] = dict(turns(
            lambda: hq.histogram_multi_quantized(*q, m, *sc),
            lambda: base_hq.histogram_multi_quantized(*q, m, *sc)),
            rows_in_slots=rows_in,
            bound_ms=_k4_bytes(inp, rows_in, m) / HBM_BYTES_PER_S * 1e3)
        nb = torch.tensor([x.num_bin for x in d.bin_mappers],
                          dtype=torch.int32, device=dev)
        miss = torch.arange(f, dtype=torch.int32, device=dev) % 3
        parent = new4[:, 0].sum(dim=1).contiguous()
        args = q + (nb, miss, parent, m) + sc
        h5, c5 = fk.fused_hist_split_quantized(*args, **kw)
        bh5, bc5 = base_fk.fused_hist_split_quantized(*args, **kw)
        _check(_bits_equal(h5.cpu().numpy(), bh5.cpu().numpy())
               and _bits_equal(c5.cpu().numpy(), bc5.cpu().numpy()),
               f"compare {name}: K5 of this checkout and the baseline differ")
        report["k5"][name] = dict(turns(
            lambda: fk.fused_hist_split_quantized(*args, **kw),
            lambda: base_fk.fused_hist_split_quantized(*args, **kw)),
            rows_in_slots=rows_in)
    report["carries"] = _compare_carries(data, seed, dev, base_hk, base_hq,
                                         timing)
    # the link kernel: exp on a stride through the 2^32 bit patterns,
    # sigmoid on OBJECTIVE_ROWS scores; bitwise, timed in turns with L2
    # warm and flushed
    rng = np.random.RandomState(seed)
    bits = (np.arange(EXP_PATTERNS, dtype=np.uint64)
            * ((1 << 32) // EXP_PATTERNS)).astype(np.uint32)
    x = torch.from_numpy(bits.view(np.float32)).to(dev)
    t = torch.from_numpy((rng.randn(OBJECTIVE_ROWS) * 4).astype(
        np.float32)).to(dev)
    _check(_bits_equal(xla_math.xla_exp_f32(x).cpu().numpy(),
                       base_xm.xla_exp_f32(x).cpu().numpy())
           and _bits_equal(xla_math.xla_sigmoid(t).cpu().numpy(),
                           base_xm.xla_sigmoid(t).cpu().numpy()),
           "compare: the link kernels of this checkout and the baseline "
           "differ")
    report["link"] = {"values": OBJECTIVE_ROWS, **turns(
        lambda: xla_math.xla_sigmoid(t), lambda: base_xm.xla_sigmoid(t))}
    if timing:
        flush = _flusher(dev)
        c = [_cuda_ms(f, flush=flush) for f in (
            lambda: xla_math.xla_sigmoid(t), lambda: base_xm.xla_sigmoid(t),
            lambda: base_xm.xla_sigmoid(t), lambda: xla_math.xla_sigmoid(t))]
        report["link"].update(l2_cold_ms=(c[0] + c[3]) / 2,
                              baseline_l2_cold_ms=(c[1] + c[2]) / 2)
    # the quantize step (train_quant's: 15 bins, stochastic rounding) on
    # OBJECTIVE_ROWS binary gradients: its draws are one threefry launch
    # each here, the baseline's may be torch ops; bitwise, in turns
    from lightgbm_tpu_torch.ops import fused as fq
    from lightgbm_tpu_torch.ops import threefry as tfq
    (base_fq,) = _import_port(baseline, "baseline_port", "ops.fused")
    p = torch.sigmoid(t)
    g, h = p - 0.5, p * (1.0 - p)
    key = tfq.fold_in(tfq.prng_key(seed), 7)
    new_q = fq.quantize_gradients(g, h, 15, key, return_scales=True)
    old_q = base_fq.quantize_gradients(g, h, 15, key, return_scales=True)
    _check(all(_bits_equal(a.cpu().numpy(), b.cpu().numpy())
               for a, b in ((new_q[0], old_q[0]), (new_q[1], old_q[1]))),
           "compare: the quantize steps of this checkout and the baseline "
           "differ")
    if timing:
        # at the host's pace only: the torch-ops draws of an older
        # checkout are more launches than the card's queue holds, so
        # they cannot be queued behind a spin kernel
        this = lambda: fq.quantize_gradients(  # noqa: E731
            g, h, 15, key, return_scales=True)
        base = lambda: base_fq.quantize_gradients(  # noqa: E731
            g, h, 15, key, return_scales=True)
        q = [_cuda_ms(f) for f in (this, base, base, this)]
        report["quantize"] = {"values": OBJECTIVE_ROWS,
                              "ms": (q[0] + q[3]) / 2,
                              "baseline_ms": (q[1] + q[2]) / 2}
    _emit(report)
    return report


def _compare_carries(data, seed, dev, base_hk, base_hq, timing=True):
    """Both carries of this checkout against the baseline's port modules
    (`base_hk`, `base_hq`): the first STREAM_CARRY_ROWS rows in the
    shards of STREAM_CUTS at S = 1 and 8, and the 2M rows in shards of
    65,536 at S = 8 (each slot's L over its rows); the finalized
    histograms bitwise (both are K1's, or K4's, over all rows); a
    shard's fold timed in turns (this, baseline, baseline, this) as
    device time and at the host's pace, the carries made outside the
    timed passes; and each design's kernels of one pass by the profiler
    (the baseline's stages: row count, row list, partial, advance or
    add)."""
    import torch
    from lightgbm_tpu_torch.ops import hist_kernel as hk
    from lightgbm_tpu_torch.ops import hist_kernel_q as hkq
    n_all = len(data.y)
    bnp = np.ascontiguousarray(data.dataset.bin_data.T)
    f, mb = bnp.shape[0], 255
    lid3 = _partition(bnp, 3)
    q = _quant_inputs(bnp, data.y, lid3, [0], seed, dev)
    bins, pay, pw3, lid = q["bins"], q["pay"], q["pw3"], q["lid"]
    stream = [0] + list(STREAM_CUTS) + [STREAM_CARRY_ROWS]
    out = {}
    for name, edges, s in (
            ("stream_200k_s1", stream, 1), ("stream_200k_s8", stream, 8),
            ("shard_65536_s8", list(range(0, n_all, 65536)) + [n_all], 8)):
        n = edges[-1]
        sl = torch.arange(s, dtype=torch.int32, device=dev)
        lengths = torch.tensor([int((lid3[:n] == k).sum()) for k in range(s)],
                               dtype=torch.int32, device=dev)
        blocks = [(bins[:, a:b].contiguous(), pay[a:b], lid[a:b],
                   pw3[:, a:b].contiguous())
                  for a, b in zip(edges[:-1], edges[1:])]
        for quantized in (False, True):
            key = f"{'int32' if quantized else 'f32'}_{name}"
            this = _carry_fns(hk, hkq, blocks, f, n, sl, mb, lengths, q,
                              quantized)
            base = _carry_fns(base_hk, base_hq, blocks, f, n, sl, mb,
                              lengths, q, quantized)
            got = [fin(run(make())).cpu() for make, run, fin in (this, base)]
            _check(_bits_equal(got[0], got[1]), f"compare {key}: the "
                   "carries of this checkout and the baseline differ")
            rep = {"shards": len(blocks)}
            if timing:
                for k, queued in (("device_ms", True), ("host_ms", False)):
                    t = [_fresh_ms(run, make, _fresh_iters(len(blocks)),
                                   queued=queued) / len(blocks)
                         for make, run, _ in (this, base, base, this)]
                    rep[k] = (t[0] + t[3]) / 2
                    rep["baseline_" + k] = (t[1] + t[2]) / 2
                for side, (make, run, _) in (("kernels", this),
                                             ("baseline_kernels", base)):
                    c = make()
                    rep[side] = _profile_kernels(lambda: run(c))
            out[key] = rep
    return out


# ----------------------------------------------------------- train_api
#: the user API slice on the train phase's data at the bench's wave
#: configuration: rounds of (a), (d), (e), (f), (g) and the 5 of (a)-(c)
API_ROUNDS = 10
API_HALF = 5
#: rows of the held-out set that (c) replays onto on the card and on the
#: CPU, and that (g) compares `predict_proba` on
API_SLICE = 50_000
#: (e): the learning rate decays by 0.95 a round, and num_leaves goes
#: from 31 to 15 at round 5
API_LR = 0.1
API_LEAVES = [31] * API_HALF + [15] * (API_ROUNDS - API_HALF)


def _tree_blocks(text, n):
    """The first `n` `Tree=` blocks of a model text, each to the blank
    line that ends it."""
    body = text.split("end of trees")[0]
    return ["Tree=" + b.rstrip("\n") for b in body.split("Tree=")[1:n + 1]]


def _shrinkage_lines(text):
    return [ln for ln in text.splitlines() if ln.startswith("shrinkage=")]


def _api_counters(modules):
    import lightgbm_tpu_torch.booster as booster_module
    from lightgbm_tpu_torch.ops import xla_math
    c = _wave_counters(modules)
    c["link"] = xla_math.LINK_LAUNCHES
    c["eval_copies"] = booster_module.EVAL_COPIES
    return c


def _zero_api_counters(modules):
    import lightgbm_tpu_torch.booster as booster_module
    from lightgbm_tpu_torch.ops import xla_math
    _zero_wave_counters(modules)
    xla_math.LINK_LAUNCHES = 0
    booster_module.EVAL_COPIES = 0


def _hidden_sklearn():
    """The port's sklearn module reloaded with scikit-learn's import
    hidden (as on a machine without it), and a function that restores
    both."""
    import importlib
    import lightgbm_tpu_torch.sklearn as mod
    saved = {k: v for k, v in sys.modules.items()
             if k == "sklearn" or k.startswith("sklearn.")}
    for k in saved:
        del sys.modules[k]
    sys.modules["sklearn"] = None
    hidden = importlib.reload(mod)

    def restore():
        del sys.modules["sklearn"]
        sys.modules.update(saved)
        importlib.reload(mod)
    return hidden, restore


def phase_train_api(data: TrainData, modules, device=None,
                    wave_report=None, rounds: int = API_ROUNDS,
                    half: int = API_HALF, api_slice: int = API_SLICE):
    """The user API around training (`lightgbm_tpu_torch` engine, booster
    and sklearn) on the train phase's data at the bench's wave
    configuration (WAVE_PARAMS), each step on a line of its own:
    (a) continued training from a saved model, (b) rollback, (c)
    `add_valid` after training started, (d) `refit`, (e) a
    `reset_parameter` schedule, (f) `cv`, (g) `LGBMClassifier` without
    scikit-learn.  Returns the phase's launches of K2, K3, K1 and the
    link kernel."""
    import tempfile
    import torch
    import lightgbm_tpu_torch as lt
    import lightgbm_tpu_torch.booster as booster_module
    from lightgbm_tpu_torch import engine
    t_phase = time.perf_counter()
    params = dict(WAVE_PARAMS)
    if device is not None:
        params["device_type"] = device
    dev = torch.device(device or "cuda")
    cpu = torch.device("cpu")
    steps = {}
    _zero_api_counters(modules)

    def done(name, t0, report):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        report["step_s"] = time.perf_counter() - t0
        steps[name] = report["step_s"]
        _emit(dict({"phase": "train_api", "step": name}, **report))

    def serve_auc(bst):
        raw = lt.ServingRuntime(bst, device=device).predict(
            data.X_hold, raw_score=True)
        return _auc(raw, data.y_hold)

    # ---- (a) continued training
    t0 = time.perf_counter()
    first, rec1 = _wave_run(params, data.dataset, modules, half, False)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_api_")
    path = os.path.join(tmp, "first.txt")
    first.save_model(path)
    with open(path) as f:
        saved = f.read()
    captured, uploaded = {}, {}
    real_predict = lt.Booster.predict

    def predict_spy(self, X, *a, **kw):
        out = real_predict(self, X, *a, **kw)
        captured.setdefault("raw", out)
        return out

    def grab_upload(env):
        if env.iteration == env.begin_iteration:
            uploaded["score"] = env.model._train_score.cpu().numpy().copy()
    grab_upload.before_iteration = True
    lt.Booster.predict = predict_spy
    try:
        cont, rec2 = _wave_run(params, data.dataset, modules, half, False,
                               init_model=path, callbacks=[grab_upload])
    finally:
        lt.Booster.predict = real_predict
    full = lt.train(params, data.dataset, num_boost_round=rounds)
    raw = captured["raw"]
    check_rows = first.predict(data.X[:api_slice], raw_score=True)
    _check(raw.shape == (data.X.shape[0],) and uploaded["score"].dtype
           == np.float32 and _bits_equal(uploaded["score"],
                                         raw.astype(np.float32))
           and _bits_equal(raw[:api_slice], check_rows),
           "train_api (a): the uploaded train score is not the f32 cast "
           "of the init model's raw prediction")
    cont_text = cont.model_to_string()
    _check(_tree_blocks(cont_text, half) == _tree_blocks(saved, half)
           and len(cont.trees) == rounds,
           "train_api (a): the continued model's first trees are not the "
           "saved model's")
    auc_cont, auc_full = serve_auc(cont), serve_auc(full)
    _check(abs(auc_cont - auc_full) <= 1e-3,
           f"train_api (a): held-out AUC {auc_cont} continued vs "
           f"{auc_full} uninterrupted")
    per_round = rec1["per_round"] + rec2["per_round"]
    for r, c in enumerate(per_round):
        _check(c["k2"] == 1 + c["hist_waves"] and c["k3"] == c["hist_waves"]
               and c["syncs"] == 1 + c["hist_waves"],
               f"train_api (a): round {r + 1} counted {c}")
    wave_rounds = (wave_report or {}).get("per_round_counts")
    done("continued", t0, {
        "rounds": [half, half], "saved_trees_identical": True,
        "uploaded_score_bitwise_f32_predict": True,
        "upload_rows": int(raw.shape[0]),
        "auc_continued": auc_cont, "auc_uninterrupted": auc_full,
        "per_round_k2_k3_syncs": [(c["k2"], c["k3"], c["syncs"])
                                  for c in per_round],
        "train_wave_per_round_k2_k3_syncs":
            [(c["k2"], c["k3"], c["syncs"]) for c in wave_rounds]
            if wave_rounds else None})

    # ---- (b) rollback
    t0 = time.perf_counter()
    hold = lt.Dataset(data.X_hold, label=data.y_hold,
                      reference=data.dataset).construct()

    def booster_with_hold(updates):
        b = lt.Booster(params=params, train_set=data.dataset)
        b.add_valid(hold, "held")
        for _ in range(updates):
            b.update()
        return b

    six = booster_with_hold(half + 1)
    five = booster_with_hold(half)
    before = [six._train_score.clone(), six._valid_scores[0].clone()]
    six.rollback_one_iter()
    _check(six.model_to_string() == five.model_to_string(),
           "train_api (b): rolled-back model text != 5-update model's")
    worst = []
    for s6, r, s in zip(before, [six._train_score, six._valid_scores[0]],
                        [five._train_score, five._valid_scores[0]]):
        s6, r, s = (x.cpu().numpy() for x in (s6, r, s))
        diff = np.abs(r.astype(np.float64) - s.astype(np.float64))
        bound = np.spacing(np.maximum(np.abs(s6), np.abs(s)))
        _check(bool(np.all(diff <= bound)),
               "train_api (b): rolled-back scores beyond the rounding of "
               "(s + c) - c")
        worst.append((float(diff.max()), int(np.sum(diff > 0))))
    replays = [0]
    real_ids = booster_module.tree_leaf_ids

    def count_ids(tree, dd):
        replays[0] += 1
        return real_ids(tree, dd)
    booster_module.tree_leaf_ids = count_ids
    try:
        six.rollback_one_iter()
    finally:
        booster_module.tree_leaf_ids = real_ids
    four = booster_with_hold(half - 1)
    _check(six.model_to_string() == four.model_to_string()
           and replays[0] == 2,
           f"train_api (b): the second rollback ({replays[0]} replays) "
           "does not give the 4-update model")
    deep = float(np.max(np.abs(six._train_score.cpu().numpy().astype(
        np.float64) - four._train_score.cpu().numpy())))
    done("rollback", t0, {
        "model_text_identical": True,
        "train_max_abs_diff_and_rows": worst[0],
        "valid_max_abs_diff_and_rows": worst[1],
        "second_rollback_replays": replays[0],
        "second_rollback_text_identical": True,
        "second_rollback_train_max_abs_diff": deep})

    # ---- (c) add_valid after the model's first iterations
    t0 = time.perf_counter()
    part = hold.subset(np.arange(api_slice)).construct()
    late = lt.Booster(params=params, train_set=data.dataset)
    for _ in range(half):
        late.update()
    late.add_valid(part, "late")
    card = late._valid_scores[0].cpu().numpy()
    host = late._replay_model(booster_module._DeviceData(part, cpu)).numpy()
    _check(_bits_equal(card, host),
           "train_api (c): the card's replay != the CPU's")
    from_start = five._valid_scores[0][:api_slice].cpu().numpy()
    _check(late.model_to_string() == five.model_to_string(),
           "train_api (c): the 5-update models differ")
    done("add_valid", t0, {
        "rows": api_slice, "replay_bitwise_cpu": True,
        "rows_differing_from_start": int(np.sum(card != from_start)),
        "max_abs_diff_from_start": float(np.max(np.abs(
            card.astype(np.float64) - from_start)))})

    # ---- (d) refit on the held-out rows
    t0 = time.perf_counter()
    from lightgbm_tpu_torch.ops import xla_math
    link0 = xla_math.LINK_LAUNCHES
    ref_card = full.refit(data.X_hold, data.y_hold, decay_rate=0.9)
    link = xla_math.LINK_LAUNCHES - link0
    ref_cpu = full.refit(data.X_hold, data.y_hold, decay_rate=0.9,
                         device_type="cpu")
    _check(ref_card.model_to_string() == ref_cpu.model_to_string()
           and ref_card.model_to_string() != full.model_to_string(),
           "train_api (d): refit on the card != on the CPU")
    _check(link == rounds if dev.type == "cuda" else True,
           f"train_api (d): {link} link launches for {rounds} rounds")
    done("refit", t0, {"rows": int(data.X_hold.shape[0]),
                       "decay_rate": 0.9, "model_text_identical_cpu": True,
                       "link_launches": link,
                       "auc_refit": serve_auc(ref_card)})

    # ---- (e) a reset_parameter schedule
    t0 = time.perf_counter()
    reset = lt.reset_parameter(learning_rate=lambda i: API_LR * 0.95 ** i,
                               num_leaves=list(API_LEAVES))
    sched, rec = _wave_run(dict(params, learning_rate=API_LR), data.dataset,
                           modules, rounds, False, callbacks=[reset])
    fresh_params = dict(params, num_leaves=API_LEAVES[-1],
                        learning_rate=API_LR * 0.95 ** half)
    _, fresh_rec = _wave_run(fresh_params, data.dataset, modules, 1, False)
    shrink = _shrinkage_lines(sched.model_to_string())
    want = [f"shrinkage={API_LR * 0.95 ** i:.17g}" for i in range(rounds)]
    leaves = [t.num_leaves for t in sched.trees]
    k2 = [c["k2"] for c in rec["per_round"]]
    _check(shrink == want, f"train_api (e): shrinkage lines {shrink}")
    _check(all(n <= API_LEAVES[-1] for n in leaves[half:])
           and all(c == fresh_rec["per_round"][0]["k2"] for c in k2[half:]),
           f"train_api (e): leaves {leaves}, K2 a round {k2} against a "
           f"fresh booster's {fresh_rec['per_round'][0]['k2']}")
    done("reset_parameter", t0, {
        "leaves_per_tree": leaves, "k2_per_round": k2,
        "fresh_booster_k2": fresh_rec["per_round"][0]["k2"],
        "shrinkage_follows_schedule": True})

    # ---- (f) cv, and the same folds as three train runs
    t0 = time.perf_counter()
    cv_params = dict(params, metric="auc", early_stopping_round=3)
    ran = [0]

    def count_round(env):
        ran[0] += 1
    c0 = _api_counters(modules)
    res = lt.cv(cv_params, data.dataset, rounds, nfold=3, stratified=True,
                callbacks=[count_round])
    c1 = _api_counters(modules)
    kept = len(res["valid auc-mean"])
    folds = engine._make_n_folds(data.dataset, None, 3, cv_params, 0,
                                 True, True)
    train_params = {k: v for k, v in cv_params.items()
                    if k != "early_stopping_round"}
    per_fold = []
    for tr_idx, te_idx in folds:
        hist = {}
        lt.train(train_params, data.dataset.subset(tr_idx), ran[0],
                 valid_sets=[data.dataset.subset(te_idx)],
                 valid_names=["valid"],
                 callbacks=[lt.record_evaluation(hist)])
        per_fold.append(hist["valid"]["auc"])
    c2 = _api_counters(modules)
    for r in range(kept):
        agg = engine._agg_cv_result([[("valid", "auc", f[r], True)]
                                     for f in per_fold])[0]
        _check(res["valid auc-mean"][r] == agg[2]
               and res["valid auc-stdv"][r] == agg[4],
               f"train_api (f): round {r + 1} cv {res['valid auc-mean'][r]}"
               f" +- {res['valid auc-stdv'][r]} against {agg[2]} +- "
               f"{agg[4]}")
    k2_cv, k2_runs = c1["k2"] - c0["k2"], c2["k2"] - c1["k2"]
    _check(k2_cv == k2_runs and k2_cv > 0,
           f"train_api (f): K2 launches cv {k2_cv}, three runs {k2_runs}")
    done("cv", t0, {
        "rows": int(data.X.shape[0]), "nfold": 3, "rounds_run": ran[0],
        "rounds_kept": kept, "auc_mean": res["valid auc-mean"],
        "auc_stdv": res["valid auc-stdv"], "bitwise_three_runs": True,
        "k2_cv": k2_cv, "k2_three_runs": k2_runs,
        "eval_copies_cv": c1["eval_copies"] - c0["eval_copies"]})

    # ---- (g) LGBMClassifier, scikit-learn absent
    t0 = time.perf_counter()
    sk, restore = _hidden_sklearn()
    try:
        _check(not sk._SKLEARN, "train_api (g): scikit-learn not hidden")
        kw = {k: v for k, v in params.items() if k != "objective"}
        clf = sk.LGBMClassifier(n_estimators=rounds, objective="binary",
                                **kw)
        t_fit = time.perf_counter()
        clf.fit(data.X, data.y)
        fit_s = time.perf_counter() - t_fit
        text = clf.booster_.model_to_string()
        same = lt.train(dict(clf.booster_.params), data.dataset,
                        num_boost_round=rounds)
        _check(text == same.model_to_string()
               and _without_params(text) == _without_params(
                   full.model_to_string()),
               "train_api (g): the estimator's model != lt.train's")
        Xs = data.X_hold[:api_slice]
        proba = clf.predict_proba(Xs)
        p = clf.booster_.predict(Xs)
        _check(_bits_equal(proba, np.vstack([1.0 - p, p]).T)
               and _bits_equal(p, full.predict(Xs))
               and list(clf.classes_) == [0.0, 1.0],
               "train_api (g): predict_proba != Booster.predict stacked")
    finally:
        restore()
    done("sklearn", t0, {"sklearn_present": False,
                         "model_text_identical_to_train": True,
                         "trees_identical_to_wave_params_train": True,
                         "predict_proba_bitwise": True, "rows": api_slice,
                         "fit_s": fit_s})

    total = _api_counters(modules)
    launches = {"fused_hist_split": total["k2"], "split_scan": total["k3"],
                "histogram": total["k1"], "xla_link": total["link"]}
    _emit({"phase": "train_api", "steps_s": steps, "launches": launches,
           "host_syncs": total["syncs"], "eval_copies": total["eval_copies"],
           "phase_s": time.perf_counter() - t_phase,
           "phase_with_setup_s": time.perf_counter() - t_phase
           + data.binning_s})
    return launches


# ------------------------------------------------------ train_breadth
#: the grower's constraints and the boosting modes on the train phase's
#: data, each setting as upstream LightGBM's docs/Parameters.rst defines
#: it: the bench's wave (WAVE_PARAMS, 31 leaves, 10 rounds), or the strict
#: grower at the train phase's 255 leaves for 3 rounds where the setting
#: needs it (the intermediate monotone method) or the case is the strict
#: grower's own (forced splits, the pool)
BREADTH_ROUNDS = TRAIN_ROUNDS
BREADTH_STRICT_ROUNDS = 3
BREADTH_STRICT = dict(TRAIN_PARAMS)
#: increasing, decreasing, increasing, decreasing on the first four of the
#: 28 features (`monotone_constraints`)
BREADTH_MONO = [1, -1, 1, -1] + [0] * (TRAIN_FEATURES - 4)
#: four groups of 7 features (`interaction_constraints`)
BREADTH_IC = [list(range(7 * g, 7 * g + 7)) for g in range(4)]
#: `cegb_penalty_split` and a coupled penalty a feature (charged once a
#: model), with the default `cegb_tradeoff` 1
BREADTH_CEGB = {"cegb_penalty_split": 1e-6,
                "cegb_penalty_feature_coupled": [
                    50.0 * (1 + f % 4) for f in range(TRAIN_FEATURES)]}
#: the root and both its children (`forcedsplits_filename`)
BREADTH_FORCED = {"feature": 0, "threshold": 0.0,
                  "left": {"feature": 1, "threshold": 0.0},
                  "right": {"feature": 2, "threshold": 0.0}}
#: `histogram_pool_size` in MB for 8 histograms of 28 x 255 x 3 f32
BREADTH_POOL_SLOTS = 8
BREADTH_POOL_MB = BREADTH_POOL_SLOTS * TRAIN_FEATURES * 255 * 3 * 4 / 2 ** 20
#: the linear run's rounds: its host fit takes over a second a round at
#: 2M rows and each of its three runs pays it, so its depth is cut to keep
#: the script well inside its time limit
BREADTH_LINEAR_ROUNDS = 5
#: rows of the held-out set whose predictions walk each monotone grid
BREADTH_GRID_ROWS = 1000
BREADTH_GRID_POINTS = 64


def _binary_logloss(preds, dataset):
    """The custom objective of the fobj run: binary logloss in numpy."""
    p = 1.0 / (1.0 + np.exp(-preds))
    return p - dataset.get_label(), p * (1.0 - p)


def _breadth_runs():
    """(name, params, rounds, kernels) of the train_breadth runs; the
    kernels are the counters of `_quant_counters` the run must launch."""
    strict = dict(BREADTH_STRICT)
    wave = dict(WAVE_PARAMS)
    mono = {"monotone_constraints": BREADTH_MONO}
    ic = dict(BREADTH_CEGB, interaction_constraints=BREADTH_IC)
    return [
        ("mono_basic", dict(wave, **mono), BREADTH_ROUNDS, ("k1",)),
        ("mono_basic_quant", dict(wave, **mono, **QUANT), BREADTH_ROUNDS,
         ("k4",)),
        ("mono_intermediate", dict(
            strict, **mono, monotone_constraints_method="intermediate",
            feature_fraction_bynode=0.5), BREADTH_STRICT_ROUNDS, ("k1",)),
        ("ic_cegb", dict(wave, **ic), BREADTH_ROUNDS, ("k2", "k3")),
        ("ic_cegb_quant", dict(wave, **ic, **QUANT), BREADTH_ROUNDS,
         ("k5", "k3")),
        ("forced_wave", dict(wave), BREADTH_ROUNDS, ("k2", "k3")),
        ("forced_strict", dict(strict), BREADTH_STRICT_ROUNDS, ("k1",)),
        ("pool", dict(strict, histogram_pool_size=BREADTH_POOL_MB),
         BREADTH_STRICT_ROUNDS, ("k1",)),
        ("dart", dict(wave, boosting="dart", drop_rate=0.1, skip_drop=0.5),
         BREADTH_ROUNDS, ("k2", "k3")),
        ("rf", dict(wave, boosting="rf", bagging_fraction=0.8,
                    bagging_freq=1, feature_fraction=0.8), BREADTH_ROUNDS,
         ("k2", "k3")),
        ("linear", dict(wave, linear_tree=True, linear_lambda=0.01),
         BREADTH_LINEAR_ROUNDS, ("k2", "k3")),
        ("fobj", dict(wave, objective=_binary_logloss), BREADTH_ROUNDS,
         ("k2", "k3")),
    ]


def _root_paths(tree):
    """The split features of every root-to-leaf path of a host Tree."""
    out, stack = [], [(0, [])]
    while stack:
        node, feats = stack.pop()
        if node < 0:
            out.append(feats)
            continue
        f = int(tree.split_feature[node])
        stack += [(int(tree.left_child[node]), feats + [f]),
                  (int(tree.right_child[node]), feats + [f])]
    return out


def _monotone_violations(bst, X, mono, rows, points):
    """Steps against each constrained feature's direction along a grid of
    `points` values over its held-out range, at `rows` held-out rows."""
    bad = 0
    base = np.repeat(X[:rows].astype(np.float64), points, axis=0)
    for f, d in enumerate(mono):
        if d == 0:
            continue
        grid = np.linspace(float(X[:, f].min()), float(X[:, f].max()),
                           points)
        Xg = base.copy()
        Xg[:, f] = np.tile(grid, rows)
        p = bst.predict(Xg, raw_score=True).reshape(rows, points)
        bad += int((np.diff(p, axis=1) * d < 0).sum())
    return bad


def _structure_diffs(a, b, rtol=1e-5):
    """Trees of `a` and `b` (the same data and settings) whose structure
    differs, and the largest relative gap between the two gains at the
    first split that differs: 0 when every tree is the same.  A tree
    whose first difference is not a near-tie (gains further apart than
    `rtol`) counts as a miss."""
    differ, misses, gap = 0, 0, 0.0
    for ta, tb in zip(a.trees, b.trees):
        n = max(ta.num_internal(), tb.num_internal())
        for i in range(n):
            if i >= min(ta.num_internal(), tb.num_internal()) or \
                    ta.split_feature[i] != tb.split_feature[i] or \
                    ta.threshold_bin[i] != tb.threshold_bin[i]:
                differ += 1
                if i < min(ta.num_internal(), tb.num_internal()):
                    ga = float(ta.split_gain[i])
                    gb = float(tb.split_gain[i])
                    g = abs(ga - gb) / max(abs(ga), abs(gb), 1e-30)
                else:
                    g = float("inf")
                gap = max(gap, g)
                misses += g > rtol
                break
    return {"trees_differ": differ, "not_near_ties": misses,
            "first_diff_gain_rel_gap": gap}


def phase_train_breadth(data: TrainData, modules, device=None,
                        timing=True, serve_rows: int = HOLD_ROWS):
    """The grower's constraints and the boosting modes (`_breadth_runs`)
    through `lightgbm_tpu_torch.train` on the train phase's data, each
    run between its own counter reads: (a) monotone basic on the wave,
    f32 (unfused: K1) and quantized (K4); (b) monotone intermediate on
    the strict grower with feature_fraction_bynode 0.5 (K1); (c)
    interaction constraints (four groups of 7) with CEGB on the fused
    wave (K2/K3) and quantized (K5/K3); (d) forced splits (the root and
    both children) on the wave and the strict grower; (e) the histogram
    pool at 8 slots of the 255-leaf strict tree, beside the unpooled run;
    (f) DART; (g) RF; (h) linear trees; (i) a numpy binary logloss as
    `fobj`.  Gates, each with zero misses: two kernel-trained runs
    byte-identical; held-out AUC within 1e-3 of the same settings with
    `hist_impl=segment_sum`; the model served by ServingRuntime on its
    rung bitwise the host walk (at f32 thresholds on the exact rungs,
    `f32_threshold_walk`; the f64 walk itself on the host-walk rung of
    linear trees); the expected kernels launched every round; and each
    run's own (monotone grids, IC paths, forced prefixes, pool structure,
    DART and RF text round trips).  Printed a run: ms per round beside
    the plain bench wave round, launches and host syncs a tree, the
    resolved policy and `hist_impl`, the linear fit's host seconds; with
    `timing`, one profiled round of the monotone basic run.  Returns the
    phase's launches of K1-K5."""
    import json as json_module
    import tempfile
    import torch
    import lightgbm_tpu_torch as lt
    import lightgbm_tpu_torch.booster as booster_module
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="breadth_")
    forced_path = os.path.join(tmp, "forced.json")
    with open(forced_path, "w") as fh:
        json_module.dump(BREADTH_FORCED, fh)
    hold_X, hold_y = data.X_hold[:serve_rows], data.y_hold[:serve_rows]
    phase_total = {k: 0 for k in ("k1", "k2", "k3", "k4", "k5")}

    def with_device(p):
        return dict(p, device_type=device) if device is not None else p

    # the plain bench wave round of this call, the runs' yardstick
    _zero_quant_counters(modules)
    _, plain = _wave_run(with_device(dict(WAVE_PARAMS)), data.dataset,
                         modules, BREADTH_ROUNDS, False,
                         counters=_quant_counters)
    plain_ms = float(np.mean(plain["round_s"][1:])) * 1e3
    for name, params, rounds, kernels in _breadth_runs():
        t_run = time.perf_counter()
        params = with_device(params)
        if name.startswith("forced"):
            params["forcedsplits_filename"] = forced_path
        drops = []

        def record_drops(env):
            drops.append(list(env.model.dart_dropped))

        _zero_quant_counters(modules)
        booster_module.LINEAR_FIT_S = 0.0
        bst, rec = _wave_run(params, data.dataset, modules, rounds, False,
                             counters=_quant_counters,
                             callbacks=[record_drops])
        total = _quant_counters(modules)
        fit_s = booster_module.LINEAR_FIT_S
        for k in phase_total:
            phase_total[k] += total[k]
        spec = bst._grower_spec
        trees = len(bst.trees)
        _check(trees == rounds, f"train_breadth {name}: {trees} trees")
        for r, c in enumerate(rec["per_round"]):
            _check(all(c[k] > 0 for k in kernels),
                   f"train_breadth {name}: round {r + 1} launched {c}, "
                   f"wants {kernels}")
            if "k2" in kernels or "k5" in kernels:
                main = "k2" if "k2" in kernels else "k5"
                _check(c[main] == 1 + c["hist_waves"]
                       and c["k3"] == c["hist_waves"],
                       f"train_breadth {name}: round {r + 1} counted {c}")
        text = bst.model_to_string()
        again = lt.train(params, data.dataset, num_boost_round=rounds)
        _check(again.model_to_string() == text,
               f"train_breadth {name}: two kernel runs differ")
        seg = lt.train(dict(params, hist_impl="segment_sum"), data.dataset,
                       num_boost_round=rounds)
        raw = bst.predict(hold_X, raw_score=True)
        _check(bool(np.all(np.isfinite(raw))),
               f"train_breadth {name}: scores not finite")
        auc = _auc(raw, hold_y)
        auc_seg = _auc(seg.predict(hold_X, raw_score=True), hold_y)
        _check(abs(auc - auc_seg) <= 1e-3,
               f"train_breadth {name}: held-out AUC {auc} vs segment_sum "
               f"{auc_seg}")
        rt = lt.ServingRuntime(bst, device=device or "cuda")
        served = rt.predict(hold_X, raw_score=True)
        walk = raw if rt.rung == "host_walk" \
            else f32_threshold_walk(bst, hold_X)
        _check(_bits_equal(served, walk),
               f"train_breadth {name}: served scores on the {rt.rung} rung "
               "!= the host walk")
        report = {
            "phase": "train_breadth", "run": name, "rounds": rounds,
            "policy": bst._grow_policy, "hist_impl": spec.hist_impl,
            "fused": spec.fused, "serve_rung": rt.rung,
            "ms_per_round_2_on": float(np.mean(rec["round_s"][1:])) * 1e3,
            "plain_wave_ms_per_round": plain_ms,
            "launches_per_round": {k: total[k] / rounds for k in
                                   ("k1", "k2", "k3", "k4", "k5")},
            "host_syncs_per_tree": total["syncs"] / trees,
            "waves_per_tree": total["waves"] / trees,
            "leaves_per_tree": [t.num_leaves for t in bst.trees],
            "auc": auc, "auc_segment_sum": auc_seg,
            "model_text_identical_twice": True, "served_bitwise": True}

        # ---- each run's own gates
        if name.startswith("mono"):
            mono = BREADTH_MONO
            bad = _monotone_violations(bst, hold_X, mono, BREADTH_GRID_ROWS,
                                       BREADTH_GRID_POINTS)
            _check(bad == 0, f"train_breadth {name}: {bad} monotone "
                   "violations")
            report["monotone_grid_violations"] = bad
            _check(not spec.fused, f"train_breadth {name}: fused")
            _check(spec.monotone_intermediate == (name == "mono_"
                                                  "intermediate"),
                   f"train_breadth {name}: method {spec}")
        if name.startswith("ic"):
            groups = [set(g) for g in BREADTH_IC]
            bad = sum(1 for t in bst.trees if t.num_leaves > 1
                      for feats in _root_paths(t)
                      if not any(set(feats) <= g for g in groups))
            _check(bad == 0, f"train_breadth {name}: {bad} paths cross "
                   "groups")
            report["ic_paths_crossing_groups"] = bad
            report["cegb_used_features"] = int(bst._cegb_used.sum())
        if name.startswith("forced"):
            mappers = data.dataset.bin_mappers
            want = [(n["feature"], mappers[n["feature"]].bin_to_value(
                mappers[n["feature"]].value_to_bin(n["threshold"])))
                for n in (BREADTH_FORCED, BREADTH_FORCED["left"],
                          BREADTH_FORCED["right"])]
            bad = sum(1 for t in bst.trees
                      if [(int(t.split_feature[i]), float(t.threshold[i]))
                          for i in range(min(3, t.num_internal()))] != want)
            _check(bad == 0, f"train_breadth {name}: {bad} trees without "
                   "the forced prefix")
            report["trees_without_forced_prefix"] = bad
        if name == "pool":
            slots = spec.hist_pool_slots
            _check(1 <= slots <= 254 and bst._grow_policy == "leafwise",
                   f"train_breadth pool: {slots} slots")
            # a parent recomputed from its rows is not bitwise the one
            # the unpooled run subtracts (ROADMAP Queue 3 (t)): the trees
            # must be the unpooled run's up to near-ties
            unpooled, urec = _wave_run(
                dict(params, histogram_pool_size=-1), data.dataset,
                modules, rounds, False, counters=_quant_counters)
            diffs = _structure_diffs(bst, unpooled)
            _check(diffs["not_near_ties"] == 0,
                   f"train_breadth pool: trees differ from the unpooled "
                   f"run's beyond near-ties: {diffs}")
            report.update(
                hist_pool_slots=slots, against_unpooled=diffs,
                unpooled_ms_per_round_2_on=float(
                    np.mean(urec["round_s"][1:])) * 1e3,
                unpooled_k1_per_round=urec["per_round"][-1]["k1"])
        if name in ("dart", "rf"):
            again = lt.Booster(model_str=text)
            _check(_bits_equal(again.predict(hold_X, raw_score=True), raw),
                   f"train_breadth {name}: the text round trip predicts "
                   "otherwise")
            report["text_round_trip_bitwise"] = True
        if name == "dart":
            report["dropped_per_round"] = drops
            _check(any(drops), "train_breadth dart: no round dropped")
        if name == "rf":
            _check("\naverage_output\n" in text,
                   "train_breadth rf: no average_output line")
            report["average_output"] = True
        if name == "linear":
            _check(all(t.is_linear for t in bst.trees if t.num_leaves > 1),
                   "train_breadth linear: trees not linear")
            report["linear_fit_host_s_per_round"] = fit_s / rounds
        if timing and name == "mono_basic":
            # (the intermediate run's round holds over 100,000 launches,
            # which the profiler takes tens of seconds to list)
            report["profiled_round"] = _profile_round(params, data.dataset)
        report["run_s"] = time.perf_counter() - t_run
        _emit(report)
    launches = {"histogram": phase_total["k1"],
                "fused_hist_split": phase_total["k2"],
                "split_scan": phase_total["k3"],
                "histogram_q": phase_total["k4"],
                "fused_hist_split_q": phase_total["k5"]}
    _emit({"phase": "train_breadth", "launches": launches,
           "plain_wave_ms_per_round": plain_ms,
           "phase_s": time.perf_counter() - t_phase,
           "phase_with_setup_s": time.perf_counter() - t_phase
           + data.binning_s})
    return launches


# ----------------------------------------------------- train_objectives
#: the regression family, one-vs-all and the cross-entropies on the
#: train phase's 2M x 28 bins at the bench's wave configuration, 5
#: rounds each; the labels are new, the bins are not re-binned
OBJ_ROUNDS = 5
#: (name, params, quantized) of the train_objectives runs
OBJ_RUNS = [("regression_l1", {}, False), ("quantile", {"alpha": 0.7}, False),
            ("mape", {}, False), ("huber", {}, False), ("fair", {}, False),
            ("poisson", {}, False), ("gamma", {}, False),
            ("tweedie", {"tweedie_variance_power": 1.5}, False),
            ("cross_entropy", {}, False), ("cross_entropy_lambda", {}, False),
            ("multiclassova", {"num_class": 3}, False),
            ("regression_l1", {}, True), ("poisson", {}, True)]
#: the objectives whose leaves `ops/renew.py` refits
RENEWED = ("regression_l1", "quantile", "mape")


def objective_label(name: str, X, seed: int):
    """A label for objective `name` from rows X: one fixed formula of
    the first features plus seeded noise, positive for poisson, gamma
    and tweedie, in [0, 1] for the cross-entropies, 3 classes for
    one-vs-all."""
    rng = np.random.RandomState(seed + 101)
    X = np.asarray(X, np.float64)
    base = (0.8 * X[:, 0] - 0.6 * X[:, 1] + 0.5 * X[:, 2] * X[:, 3]
            + 0.4 * np.sin(2 * X[:, 4]))
    noise = rng.randn(len(X))
    if name == "poisson":
        return rng.poisson(np.exp(0.4 * base)).astype(np.float64)
    if name == "gamma":
        return np.exp(0.3 * base) * rng.gamma(2.0, 0.5, len(X)) + 0.01
    if name == "tweedie":
        return (rng.gamma(1.0, 1.0, len(X)) * (rng.rand(len(X)) < 0.7)
                * np.exp(0.3 * base))
    if name in ("cross_entropy", "cross_entropy_lambda"):
        return 1.0 / (1.0 + np.exp(-(base + 0.5 * noise)))
    if name == "multiclassova":
        return np.digitize(base + 0.3 * noise,
                           np.quantile(base, [0.4, 0.75])).astype(np.float64)
    return 3.0 * base + noise


def _objective_metric(name, params, raw, label):
    """The objective's default metric of raw scores (the port's metrics,
    host f64)."""
    from lightgbm_tpu_torch.metrics import create_metrics
    from lightgbm_tpu_torch.utils.config import Config
    cfg = Config(dict(params))
    (m,) = create_metrics(cfg, cfg.default_metric()[:1])
    return m.name, float(m.eval(np.asarray(raw, np.float64),
                                np.asarray(label, np.float64), None,
                                None)[0][1])


class _RenewRecorder:
    """Wraps the booster's `renew_leaf_values`: every call's inputs and
    output copied to the host, for the CPU's plain percentile."""

    def __init__(self, limit=2):
        self.calls, self.limit = [], limit

    def __enter__(self):
        import lightgbm_tpu_torch.booster as bm
        self.bm, self.real = bm, bm.renew_leaf_values

        def rec(*a, **kw):
            out = self.real(*a, **kw)
            if len(self.calls) < self.limit:
                self.calls.append(([x.cpu() if hasattr(x, "cpu") else x
                                    for x in a], dict(kw), out.cpu()))
            return out
        bm.renew_leaf_values = rec
        return self

    def __exit__(self, *exc):
        self.bm.renew_leaf_values = self.real


def phase_train_objectives(data: TrainData, modules, device=None,
                           timing=True, serve_rows: int = HOLD_ROWS):
    """Every objective of `OBJ_RUNS` through `lightgbm_tpu_torch.train`
    on the train phase's bins with that objective's label
    (`objective_label`; the bins carried over with
    `interop.dataset_from_numpy`, not re-binned), at WAVE_PARAMS for
    OBJ_ROUNDS rounds, f32 (K2/K3) and quantized for regression_l1 and
    poisson (K5/K3).  Gates, each with zero misses: two kernel-trained
    runs byte-identical; the objective's own metric on the held-out rows
    within 1e-3 relative of a `hist_impl=segment_sum` run on the card;
    for L1, quantile and MAPE the renewed leaf values of the first two
    trees bitwise the port's plain `leaf_percentile` on the CPU over the
    card's leaf ids, residuals and weights; the model served by
    ServingRuntime bitwise the host walk; the expected kernels every
    round.  Printed a run: ms per round beside the plain bench wave
    round of this call, launches a round.  Returns the phase's launches
    of K1-K5."""
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.interop import dataset_from_numpy
    from lightgbm_tpu_torch.ops.renew import renew_leaf_values
    t_phase = time.perf_counter()
    ds = data.dataset
    mappers = [m.to_dict() for m in ds.bin_mappers]
    hold_X = data.X_hold[:serve_rows]
    phase_total = {k: 0 for k in ("k1", "k2", "k3", "k4", "k5")}

    def with_device(p):
        return dict(p, device_type=device) if device is not None else p

    _zero_quant_counters(modules)
    _, plain = _wave_run(with_device(dict(WAVE_PARAMS)), ds, modules,
                         OBJ_ROUNDS, False, counters=_quant_counters)
    plain_ms = float(np.mean(plain["round_s"][1:])) * 1e3
    for name, extra, quant in OBJ_RUNS:
        t_run = time.perf_counter()
        run = name + ("_quant" if quant else "")
        params = with_device(dict(WAVE_PARAMS, objective=name, **extra,
                                  **(QUANT if quant else {})))
        y = objective_label(name, data.X, 0)
        y_hold = objective_label(name, hold_X, 1)
        dset = dataset_from_numpy(ds.bin_data, mappers, label=y,
                                  feature_names=ds.get_feature_name())
        _zero_quant_counters(modules)
        with _RenewRecorder() as renew:
            bst, rec = _wave_run(params, dset, modules, OBJ_ROUNDS, False,
                                 counters=_quant_counters)
        total = _quant_counters(modules)
        for k in phase_total:
            phase_total[k] += total[k]
        K = bst.num_tree_per_iteration
        _check(len(bst.trees) == OBJ_ROUNDS * K,
               f"train_objectives {run}: {len(bst.trees)} trees")
        main = "k5" if quant else "k2"
        # (cross_entropy_lambda's gradients stall after the first tree,
        # as the reference's do: a root that cannot split launches its
        # K2 or K5 alone)
        for r, c in enumerate(rec["per_round"]):
            _check(c[main] > 0 and c["k3"] == c["hist_waves"],
                   f"train_objectives {run}: round {r + 1} launched {c}")
        text = bst.model_to_string()
        again = lt.train(params, dset, num_boost_round=OBJ_ROUNDS)
        _check(again.model_to_string() == text,
               f"train_objectives {run}: two kernel runs differ")
        seg = lt.train(dict(params, hist_impl="segment_sum"), dset,
                       num_boost_round=OBJ_ROUNDS)
        raw = bst.predict(hold_X, raw_score=True)
        _check(bool(np.all(np.isfinite(raw))),
               f"train_objectives {run}: scores not finite")
        metric, value = _objective_metric(name, params, raw, y_hold)
        _, value_seg = _objective_metric(
            name, params, seg.predict(hold_X, raw_score=True), y_hold)
        rel = abs(value - value_seg) / max(abs(value_seg), 1e-12)
        _check(rel <= 1e-3, f"train_objectives {run}: held-out {metric} "
               f"{value} vs segment_sum {value_seg}")
        renew_bitwise = None
        if name in RENEWED:
            _check(len(renew.calls) == 2,
                   f"train_objectives {run}: {len(renew.calls)} renewals")
            for args, kw, out in renew.calls:
                want = renew_leaf_values(*args, **kw)
                _check(_bits_equal(out.numpy(), want.numpy()),
                       f"train_objectives {run}: renewed leaves differ "
                       "from the CPU's plain percentile")
            renew_bitwise = True
        rt = lt.ServingRuntime(bst, device=device or "cuda")
        served = rt.predict(hold_X, raw_score=True)
        _check(_bits_equal(served, f32_threshold_walk(bst, hold_X)),
               f"train_objectives {run}: served scores on the {rt.rung} "
               "rung != the host walk")
        _emit({"phase": "train_objectives", "run": run, "rounds": OBJ_ROUNDS,
               "hist_impl": bst._grower_spec.hist_impl,
               "fused": bst._grower_spec.fused,
               "ms_per_round_2_on": float(np.mean(rec["round_s"][1:])) * 1e3,
               "plain_wave_ms_per_round": plain_ms,
               "launches_per_round": {k: total[k] / OBJ_ROUNDS for k in
                                      ("k1", "k2", "k3", "k4", "k5")},
               "metric": metric, "held_out": value,
               "held_out_segment_sum": value_seg, "rel_gap": rel,
               "renewed_leaves_bitwise_cpu": renew_bitwise,
               "model_text_identical_twice": True, "served_bitwise": True,
               "serve_rung": rt.rung, "run_s": time.perf_counter() - t_run})
    launches = {"histogram": phase_total["k1"],
                "fused_hist_split": phase_total["k2"],
                "split_scan": phase_total["k3"],
                "histogram_q": phase_total["k4"],
                "fused_hist_split_q": phase_total["k5"]}
    _emit({"phase": "train_objectives", "launches": launches,
           "plain_wave_ms_per_round": plain_ms,
           "phase_s": time.perf_counter() - t_phase})
    return launches


# ---------------------------------------------------------- train_rank
#: the query-grouped set at MSLR-WEB10K's published width and scale
#: (Microsoft Learning to Rank datasets, Fold1's training split: 136
#: features, about 720,000 rows in 6,000 queries): synthetic, from the
#: seed; 1,000 more queries are held out
RANK_FEATURES = 136
RANK_QUERIES = 6000
RANK_HOLD_QUERIES = 1000
RANK_ROUNDS = 10
RANK_PARAMS = dict(WAVE_PARAMS, objective="lambdarank", metric="ndcg",
                   eval_at=[1, 3, 5, 10])


class RankData:
    """The synthetic MSLR-like set: long-tailed query sizes (median about
    110 documents, the longest 900), graded labels 0-4 from a noisy
    function of a few features (about half 0, a few percent 3 or 4), and
    positions from a noisier "logged" ranking of each query."""

    def __init__(self, seed: int, queries: int = RANK_QUERIES,
                 hold: int = RANK_HOLD_QUERIES, f: int = RANK_FEATURES):
        import lightgbm_tpu_torch as lt
        rng = np.random.RandomState(seed + 7)
        sizes = np.clip(np.round(np.exp(rng.normal(np.log(110.0), 0.55,
                                                   queries + hold))),
                        5, 900).astype(np.int64)
        sizes[rng.randint(0, queries)] = 900
        n = int(sizes.sum())
        # two decimals, as fixed-precision LETOR features are written
        # (a continuous column's 200,000 distinct sample values cost the
        # host binning minutes: ROADMAP Queue 1 item 5i)
        X = np.round(rng.randn(n, f), 2).astype(np.float32)
        qid = np.repeat(np.arange(len(sizes)), sizes)
        qshift = rng.randn(len(sizes))[qid]
        rel = (1.0 * X[:, 0] + 0.6 * X[:, 1] - 0.4 * X[:, 2] * X[:, 3]
               + 0.3 * qshift + 0.8 * rng.randn(n))
        y = np.digitize(rel, np.quantile(rel, [0.5, 0.8, 0.95, 0.985]))
        logged = rel + 1.5 * rng.randn(n)
        starts = np.concatenate([[0], np.cumsum(sizes)])
        pos = np.empty(n, np.int64)
        for q in range(len(sizes)):
            a, b = starts[q], starts[q + 1]
            pos[a:b] = np.argsort(np.argsort(-logged[a:b]))
        cut = int(starts[queries])
        self.sizes, self.hold_sizes = sizes[:queries], sizes[queries:]
        self.X, self.y, self.pos = X[:cut], y[:cut].astype(np.float64), \
            pos[:cut]
        self.X_hold, self.y_hold = X[cut:], y[cut:].astype(np.float64)
        self.hold_qb = np.concatenate([[0], np.cumsum(self.hold_sizes)])
        t0 = time.perf_counter()
        self.dataset = lt.Dataset(self.X, label=self.y, group=self.sizes,
                                  params=dict(RANK_PARAMS),
                                  free_raw_data=False).construct()
        self.binning_s = time.perf_counter() - t0


def _ndcg_at(raw, data, k=10):
    from lightgbm_tpu_torch.metrics import _ndcg_bucketed
    lg = np.asarray([float((1 << i) - 1) for i in range(31)])
    return _ndcg_bucketed(np.asarray(raw, np.float64), data.y_hold,
                          data.hold_qb, (k,), lg)[0][1]


def _lambda_grads(params, dataset, score, device):
    """(grad, hess) of the booster's objective at `score` on `device`,
    and the objective (`init_meta` on the set's labels and queries)."""
    import torch
    from lightgbm_tpu_torch.objectives import create_objective
    from lightgbm_tpu_torch.utils.config import Config
    obj = create_objective(Config(dict(params)))
    obj.init_meta(dataset.get_label().astype(np.float64), None,
                  dataset._query_boundaries)
    lab = torch.from_numpy(dataset.get_label().astype(np.float32)).to(device)
    s = torch.from_numpy(np.asarray(score, np.float32)).to(device)
    g, h = obj.grad_hess(s, lab, None)
    return g.cpu().numpy(), h.cpu().numpy()


def phase_train_rank(rd: RankData, modules, device=None, timing=True):
    """lambdarank and rank_xendcg through `lightgbm_tpu_torch.train` on
    the MSLR-like set (`RankData`) at RANK_PARAMS for RANK_ROUNDS rounds:
    lambdarank f32 on the fused wave (K2/K3) twice, with
    `hist_impl=segment_sum`, quantized (K5/K3), rank_xendcg (threefry
    draws its gammas, one launch a bucket a round) and lambdarank with
    positions.  Gates, each with zero misses: the two runs byte-identical;
    held-out NDCG@10 within 1e-3 of the segment_sum run and higher after
    round 10 than after round 1; the card's gradients and hessians at
    round 1's all-equal scores and at round 5's within rtol 1e-5 of the
    port's plain CPU computation (the largest gap and whether bitwise
    printed); the propensities finite with t_plus[0] = t_minus[0] = 1;
    every model served bitwise the host walk.  Printed: ms per round a
    run, and with `timing` the lambdas' share of a round and their
    launches (torch.profiler).  Returns the phase's launches of K1-K5 and
    threefry."""
    import torch
    import lightgbm_tpu_torch as lt
    t_phase = time.perf_counter()
    dev = torch.device(device or "cuda")
    total = {k: 0 for k in ("k1", "k2", "k3", "k4", "k5", "threefry")}

    def with_device(p):
        return dict(p, device_type=device) if device is not None else p

    def run(name, params, dataset=None):
        _zero_quant_counters(modules)
        bst, rec = _wave_run(with_device(params), dataset or rd.dataset,
                             modules, RANK_ROUNDS, False,
                             counters=_quant_counters)
        got = _quant_counters(modules)
        for k in total:
            total[k] += got[k]
        raw = bst.predict(rd.X_hold, raw_score=True)
        _check(bool(np.all(np.isfinite(raw))),
               f"train_rank {name}: scores not finite")
        rt = lt.ServingRuntime(bst, device=device or "cuda")
        _check(_bits_equal(rt.predict(rd.X_hold, raw_score=True),
                           f32_threshold_walk(bst, rd.X_hold)),
               f"train_rank {name}: served scores != the host walk")
        report = {"phase": "train_rank", "run": name,
                  "rounds": RANK_ROUNDS,
                  "ms_per_round_2_on": float(np.mean(rec["round_s"][1:]))
                  * 1e3,
                  "launches_per_round": {k: got[k] / RANK_ROUNDS
                                         for k in total},
                  "ndcg10_held_out": _ndcg_at(raw, rd),
                  "ndcg10_held_out_round_1": _ndcg_at(bst.predict(
                      rd.X_hold, raw_score=True, num_iteration=1), rd),
                  "served_bitwise": True}
        return bst, rec, report

    bst, rec, rep = run("lambdarank", dict(RANK_PARAMS))
    for r, c in enumerate(rec["per_round"]):
        _check(c["k2"] > 0 and c["k3"] > 0,
               f"train_rank lambdarank: round {r + 1} launched {c}")
    text = bst.model_to_string()
    again = lt.train(with_device(dict(RANK_PARAMS)), rd.dataset,
                     num_boost_round=RANK_ROUNDS)
    _check(again.model_to_string() == text,
           "train_rank lambdarank: two kernel runs differ")
    seg = lt.train(with_device(dict(RANK_PARAMS, hist_impl="segment_sum")),
                   rd.dataset, num_boost_round=RANK_ROUNDS)
    nd_seg = _ndcg_at(seg.predict(rd.X_hold, raw_score=True), rd)
    _check(abs(rep["ndcg10_held_out"] - nd_seg) <= 1e-3,
           f"train_rank: NDCG@10 {rep['ndcg10_held_out']} vs segment_sum "
           f"{nd_seg}")
    _check(rep["ndcg10_held_out"] > rep["ndcg10_held_out_round_1"],
           "train_rank: NDCG@10 did not rise from round 1 to round 10")
    # the lambdas on the card against the CPU's, on the same scores
    grads = {}
    for at in (1, 5):
        score = np.zeros(len(rd.y), np.float32) if at == 1 else \
            bst.predict(rd.X, raw_score=True, num_iteration=at - 1)\
            .astype(np.float32)
        gd, hd = _lambda_grads(RANK_PARAMS, rd.dataset, score, dev)
        gc, hc = _lambda_grads(RANK_PARAMS, rd.dataset, score, "cpu")
        gap = max(float(np.max(np.abs(gd - gc) / np.maximum(
            np.abs(gc), 1e-30) * (gd != gc))),
            float(np.max(np.abs(hd - hc) / np.maximum(np.abs(hc), 1e-30)
                         * (hd != hc))))
        _check(np.allclose(gd, gc, rtol=1e-5, atol=0)
               and np.allclose(hd, hc, rtol=1e-5, atol=0),
               f"train_rank: round {at} lambdas on the card differ from "
               f"the CPU's (largest relative gap {gap})")
        grads[f"round_{at}"] = {"max_rel_gap": gap,
                                "bitwise": _bits_equal(gd, gc)
                                and _bits_equal(hd, hc)}
    rep.update(model_text_identical_twice=True,
               ndcg10_segment_sum=nd_seg, lambdas_vs_cpu=grads,
               buckets=len(bst._train_obj._buckets))
    if timing:
        rep["profiled_lambdas"] = _profile_lambdas(
            bst, rep["ms_per_round_2_on"])
    _emit(rep)

    _, _, rep = run("lambdarank_quant", dict(RANK_PARAMS, **QUANT))
    _check(rep["launches_per_round"]["k5"] > 0,
           "train_rank quantized: no K5 launch")
    _emit(rep)

    xbst, _, rep = run("rank_xendcg", dict(RANK_PARAMS,
                                           objective="rank_xendcg"))
    buckets = len(xbst._train_obj._buckets)
    draws = rep["launches_per_round"]["threefry"]
    if dev.type == "cuda":
        _check(draws == buckets, f"train_rank rank_xendcg: {draws} "
               f"threefry launches a round, {buckets} buckets")
    rep["buckets"] = buckets
    _emit(rep)

    from lightgbm_tpu_torch.interop import dataset_from_numpy
    pos_set = dataset_from_numpy(
        rd.dataset.bin_data, [m.to_dict() for m in rd.dataset.bin_mappers],
        label=rd.y, group=rd.sizes, position=rd.pos)
    pbst, _, rep = run("lambdarank_positions", dict(RANK_PARAMS), pos_set)
    t_plus, t_minus = (t.cpu().numpy() for t in pbst._obj_state)
    _check(bool(np.isfinite(t_plus).all() and np.isfinite(t_minus).all())
           and t_plus[0] == 1.0 and t_minus[0] == 1.0,
           "train_rank positions: propensities not finite or not anchored")
    rep.update(positions=int(len(t_plus)),
               t_plus_first_last=[float(t_plus[1]), float(t_plus[-1])])
    _emit(rep)
    launches = {"histogram": total["k1"], "fused_hist_split": total["k2"],
                "split_scan": total["k3"], "histogram_q": total["k4"],
                "fused_hist_split_q": total["k5"],
                "threefry": total["threefry"]}
    _emit({"phase": "train_rank", "launches": launches,
           "rows": len(rd.y), "queries": len(rd.sizes),
           "median_query": float(np.median(rd.sizes)),
           "longest_query": int(rd.sizes.max()),
           "label_shares": np.bincount(rd.y.astype(int), minlength=5)
           .astype(float).__truediv__(len(rd.y)).tolist(),
           "binning_s": rd.binning_s,
           "phase_s": time.perf_counter() - t_phase})
    return launches


def _profile_lambdas(bst, round_ms):
    """The lambdas (`grad_hess` at the booster's last scores) timed on
    the host clock, synchronised, as a share of the run's round
    (`round_ms`), and the kernels they launch with their device time
    (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    obj = bst._train_obj
    score = bst._train_score
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    obj.grad_hess(score, bst._dd.label, None)
    torch.cuda.synchronize()
    lam_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        obj.grad_hess(score, bst._dd.label, None)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"lambdas_ms": lam_ms, "lambdas_launches": len(kernels),
            "lambdas_device_ms": sum(e.time_range.elapsed_us()
                                     for e in kernels) / 1e3,
            "round_ms": round_ms,
            "lambdas_share_of_round": lam_ms / round_ms}


# --------------------------------------------------------- train_sparse
#: a seeded CSR matrix of 200,000 x 1,000 at 0.5% density (count values
#: in 20 blocks of 50 mutually exclusive columns: `make_sparse`)
SPARSE_ROWS = 200_000
SPARSE_COLS = 1_000
SPARSE_DENSITY = 0.005
SPARSE_ROUNDS = 10


def make_sparse(seed: int, n=SPARSE_ROWS, f=SPARSE_COLS,
                density=SPARSE_DENSITY, group=50):
    """A CSR matrix of `n` x `f` with `density` stored values: count
    features (1 to 4) in blocks of `group` mutually exclusive columns
    (one-hot-like fields, as bag-of-words or one-hot categorical inputs
    are), a row holding a value in a block with probability density *
    group; and a binary label from a few columns of the first blocks."""
    import scipy.sparse as sps
    rng = np.random.RandomState(seed + 13)
    blocks = f // group
    hit = rng.rand(n, blocks) < density * group
    rows, blk = np.nonzero(hit)
    cols = blk * group + rng.randint(0, group, len(rows))
    vals = rng.randint(1, 5, len(rows)).astype(np.float64)
    m = sps.csr_matrix((vals, (rows, cols)), shape=(n, f))
    head = np.asarray(m[:, [0, 1, group, group + 1, 2 * group]].toarray())
    score = head @ np.array([1.0, -1.0, 0.8, 0.6, -0.7])
    y = (score + 0.3 * rng.randn(n) > 0.0).astype(np.float64)
    return m, y


def phase_train_sparse(seed: int, modules, device=None):
    """The CSR matrix of `make_sparse` through `lightgbm_tpu_torch.train`
    at WAVE_PARAMS for SPARSE_ROUNDS rounds.  Gates: construction leaves
    `bin_data` None and EFB bundles the columns; the model text byte for
    byte the one trained from the same matrix given dense (`toarray()`)
    and the one trained from the set after `save_binary` /
    `load_binary`; the model served bitwise the host walk.  Printed:
    binning seconds of the sparse and the dense form, the bundled
    columns, ms per round, launches.  Returns the phase's launches of
    K1-K5."""
    import tempfile
    import lightgbm_tpu_torch as lt
    t_phase = time.perf_counter()
    m, y = make_sparse(seed)
    params = dict(WAVE_PARAMS)
    if device is not None:
        params["device_type"] = device
    t0 = time.perf_counter()
    ds = lt.Dataset(m, label=y, params=dict(params)).construct()
    sparse_s = time.perf_counter() - t0
    _check(ds.bin_data is None and ds.efb is not None,
           "train_sparse: the sparse set has a dense bin matrix or no "
           "bundles")
    _zero_quant_counters(modules)
    bst, rec = _wave_run(params, ds, modules, SPARSE_ROUNDS, False,
                         counters=_quant_counters)
    got = _quant_counters(modules)
    for r, c in enumerate(rec["per_round"]):
        _check(c["k2"] + c["k1"] > 0,
               f"train_sparse: round {r + 1} launched {c}")
    text = bst.model_to_string()
    tmp = tempfile.mkdtemp(prefix="sparse_")
    path = os.path.join(tmp, "sparse.bin")
    ds.save_binary(path)
    loaded = lt.Dataset.load_binary(path)
    _check(lt.train(params, loaded, SPARSE_ROUNDS).model_to_string() == text,
           "train_sparse: the binary cache's model differs")
    dense = m.toarray()
    t0 = time.perf_counter()
    dd = lt.Dataset(dense, label=y, params=dict(params)).construct()
    dense_s = time.perf_counter() - t0
    _check(lt.train(params, dd, SPARSE_ROUNDS).model_to_string() == text,
           "train_sparse: the dense form's model differs")
    del dense, dd
    X = m[:20_000].toarray()
    rt = lt.ServingRuntime(bst, device=device or "cuda")
    _check(_bits_equal(rt.predict(X, raw_score=True),
                       f32_threshold_walk(bst, X)),
           "train_sparse: served scores != the host walk")
    launches = {"histogram": got["k1"], "fused_hist_split": got["k2"],
                "split_scan": got["k3"], "histogram_q": got["k4"],
                "fused_hist_split_q": got["k5"]}
    _emit({"phase": "train_sparse", "rows": m.shape[0], "cols": m.shape[1],
           "stored": int(m.nnz), "bundled_cols": int(ds.efb.n_cols),
           "binning_sparse_s": sparse_s, "binning_dense_s": dense_s,
           "hist_impl": bst._grower_spec.hist_impl,
           "fused": bst._grower_spec.fused,
           "ms_per_round_2_on": float(np.mean(rec["round_s"][1:])) * 1e3,
           "launches_per_round": {k: got[k] / SPARSE_ROUNDS
                                  for k in ("k1", "k2", "k3")},
           "model_text_dense_identical": True,
           "model_text_binary_identical": True, "served_bitwise": True,
           "launches": launches, "phase_s": time.perf_counter() - t_phase})
    return launches


# ------------------------------------------------------- train_files
#: the file set: the first FILE_ROWS rows of the train phase's 2M x 28
#: (a cut for the script's run time: each of the phase's six
#: constructions runs the greedy bin search over every row, since
#: two_round equals the whole-file route only with
#: bin_construct_sample_cnt >= the file's rows); the bench's wave
FILE_ROWS = 50_000
FILE_ROUNDS = 10
FILE_PARAMS = dict(WAVE_PARAMS, bin_construct_sample_cnt=FILE_ROWS)
#: external memory on the 2M rows: the bench's wave on the bench's
#: binning (the train phase's Dataset is the in-memory baseline); the
#: second run in 31 shards
EXT_PARAMS = dict(WAVE_PARAMS)
EXT_SHARD_ROWS = 65536
EXT_PREFETCH = 2
#: rows of the served sizes at which the host walks are timed
HOST_WALK_ROWS = (1, 256, 4096)


def write_data_file(path, X, y, fmt):
    """X [n, F] and the label y as "csv" (a header line), "tsv" or
    "libsvm" (every column, 1-based), each value with 17 significant
    digits, so that it parses back to the same double."""
    n, f = X.shape
    if fmt == "libsvm":
        line = "%.17g " + " ".join(f"{j + 1}:%.17g" for j in range(f))
    else:
        line = ("," if fmt == "csv" else "\t").join(["%.17g"] * (f + 1))
    line += "\n"
    data = np.column_stack([y, X.astype(np.float64)])
    with open(path, "w") as fh:
        if fmt == "csv":
            fh.write("label," + ",".join(f"f{j}" for j in range(f)) + "\n")
        for lo in range(0, n, 8192):
            fh.write("".join(line % tuple(r)
                             for r in data[lo:lo + 8192].tolist()))
    return path


def _file_run(path, params, modules, rounds):
    """A file's Dataset constructed (its parse, the greedy bin search,
    and the two_round passes timed apart) and trained; (booster,
    per-round counts, timings).  Gates that the route asked for ran:
    two_round never reads the file whole (`data` stays the path), and
    into the store it holds no bin matrix and training assembles the
    store once."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch import native
    from lightgbm_tpu_torch.basic import Dataset
    from lightgbm_tpu_torch.datastore import assemble
    ds = lt.Dataset(path, params=dict(params))
    t0 = time.perf_counter()
    with _CallTimer(native, "parse_dense") as dense, \
            _CallTimer(native, "parse_libsvm") as svm, \
            _CallTimer(Dataset, "_fit_one_mapper") as search:
        ds.construct()
    t1 = time.perf_counter()
    times = {"construct_s": t1 - t0, "search_s": search.s,
             "parse_s": dense.s + svm.s}
    two_round = bool(params.get("two_round"))
    store = bool(params.get("external_memory"))
    if two_round:
        _check(ds.data == path and dense.calls == 0,
               f"train_files: {path} two_round read the file whole")
        times.update(pass1_s=search.first - t0, pass2_s=t1 - search.last)
    if store:
        _check(ds.datastore is not None and ds.bin_data is None,
               f"train_files: {path} was not spilled to the store")
    _zero_wave_counters(modules)
    with _CallTimer(assemble, "assemble_feature_major", sync=True) as asm:
        bst, rec = _wave_run(params, ds, modules, rounds, False)
    _check(asm.calls == (1 if store else 0),
           f"train_files: {path}: {asm.calls} assemblies")
    if store:
        times.update(assemble_s=asm.s, shards=ds.datastore.n_shards)
    times["ms_per_round_2_on"] = float(np.mean(rec["round_s"][1:])) * 1e3
    return bst, rec, times


def _spilled_run(X, y, params, modules, rounds, datastore_dir):
    """The 2M rows spilled (`external_memory`) and trained: (booster,
    per-round counts, the spill's and the assembly's figures)."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.basic import Dataset
    from lightgbm_tpu_torch.datastore import assemble
    from lightgbm_tpu_torch.telemetry import REGISTRY
    params = dict(params, external_memory=True, datastore_dir=datastore_dir)
    ds = lt.Dataset(X, label=y, params=params)
    t0 = time.perf_counter()
    with _CallTimer(Dataset, "_spill_to_datastore") as spill:
        ds.construct()
    construct_s = time.perf_counter() - t0
    store = ds.datastore
    _zero_wave_counters(modules)
    with _CallTimer(assemble, "assemble_feature_major", sync=True) as asm:
        bst, rec = _wave_run(params, ds, modules, rounds, False)
    _check(asm.calls == 1, f"train_files: {asm.calls} assemblies")
    stats = bst._dd.pf_stats
    nbytes = store.total_bytes("bins")
    return ds, bst, rec, {
        "shards": store.n_shards, "shard_rows": store.shard_rows,
        "spill_bytes": store.total_bytes(), "bins_bytes": nbytes,
        "construct_s": construct_s, "spill_s": spill.s,
        "assemble_s": asm.s, "assemble_gb_per_s": nbytes / asm.s / 1e9,
        "prefetch_hits": stats.hits, "prefetch_stalls": stats.stalls,
        "peak_resident_mb": REGISTRY.gauge(
            "datastore.peak_resident_mb").value,
        "ms_per_round_2_on": float(np.mean(rec["round_s"][1:])) * 1e3,
        "round_1_ms": float(rec["round_s"][0]) * 1e3}


def _k23(rec):
    return [(c["k2"], c["k3"]) for c in rec["per_round"]]


def _host_walks(bst, X):
    """`bst`'s raw scores of X through the library's host walk and tree
    by tree in numpy, each timed; gate: bitwise equal.  (library, numpy,
    seconds of each)"""
    from lightgbm_tpu_torch import native
    X = np.asarray(X, dtype=np.float64)
    t0 = time.perf_counter()
    lib = bst.predict(X, raw_score=True)
    t1 = time.perf_counter()
    walk = sum(t.predict(X) for t in bst.trees)
    t2 = time.perf_counter()
    _check(_bits_equal(lib, walk), "train_files: the library's host walk "
           "!= the numpy walk")
    return lib, walk, {"rows": len(X), "trees": len(bst.trees),
                       "openmp": native.lib_info()["openmp"],
                       "cpus": os.cpu_count(),
                       "library_s": t1 - t0, "numpy_s": t2 - t1}


def phase_train_files(data: TrainData, modules, device=None,
                      rows: int = FILE_ROWS, rounds: int = FILE_ROUNDS,
                      seed: int = 0):
    """File input and external memory (ROADMAP Queue 1 item 5i and 5e's
    first half) on the card.  The host library: its compiler, OpenMP
    and build seconds.  The train phase's binning split into the greedy
    bin search and the value-to-bin pass, the pass timed through the
    library and through its plain numpy version (gate: the same codes).
    The first `rows` rows written as CSV with a header, TSV and LibSVM,
    each trained with the bench's wave for `rounds` rounds (CSV also
    two_round, and two_round straight into the shard store); gate: every
    model text the array's byte for byte (less the parameter lines where
    the ingest's own parameters differ), the same K2 and K3 launches a
    round; two_round read the file in chunks only, and into the store
    held no bin matrix and assembled once.  Predictions from the CSV:
    the host walk bitwise the array's and the numpy walk,
    `device_predict` bitwise the array's; the library's walk and the
    numpy walk timed here and at the served sizes on the main phase's
    forest (from `seed`).  The 2M rows (EXT_PARAMS)
    spilled at the default budget and at 31 shards, trained: gate the
    in-memory model (the train phase's Dataset), the same K2 and K3
    launches a round; spill, assembly, prefetch figures.  A flipped byte in a
    shard: training raises naming the file.  Returns the phase's
    launches of K1-K5."""
    import shutil
    import tempfile
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch import native
    from lightgbm_tpu_torch.datastore import ShardStore
    t_phase = time.perf_counter()
    report = {"phase": "train_files", "library": native.lib_info(),
              "binning": {"rows": len(data.X), "binning_s": data.binning_s,
                          "search_s": data.search_s,
                          "pass_s": data.pass_s}}
    tmp = tempfile.mkdtemp(prefix="train_files_")
    counts = {"k1": 0, "k2": 0, "k3": 0, "k4": 0, "k5": 0}

    def add(total):
        for k in counts:
            counts[k] += total.get(k, 0)

    try:
        # ---- the value-to-bin pass of the 2M x 28: through the library
        # in the train phase's binning (`pass_s`), and through numpy
        mappers = data.dataset.bin_mappers
        raw = data.X.astype(np.float64)
        t0 = time.perf_counter()
        plain = np.empty_like(data.dataset.bin_data)
        for j, m in enumerate(mappers):
            nn = m.num_bin - (m.missing_type == 2)
            plain[:, j] = native.values_to_bins_plain(
                raw[:, j], m.bin_upper_bound[:nn], m.missing_type,
                m.num_bin - 1)
        plain_s = time.perf_counter() - t0
        del raw
        _check(np.array_equal(plain, data.dataset.bin_data),
               "train_files: the library's codes differ from numpy's")
        report["binning"].update(pass_numpy_s=plain_s, codes_equal=True)

        # ---- the file set: the array's model, then each file's
        X, y = data.X[:rows], data.y[:rows]
        params = dict(FILE_PARAMS)
        if device is not None:
            params["device_type"] = device
        _zero_wave_counters(modules)
        arr_ds = lt.Dataset(X, label=y, params=dict(params))
        bst, rec = _wave_run(params, arr_ds, modules, rounds, False)
        add(_wave_counters(modules))
        text, k23 = bst.model_to_string(), _k23(rec)
        _check(arr_ds.efb is None, "train_files: the file set bundles")
        files = {}
        runs = {}
        for fmt in ("csv", "tsv", "libsvm"):
            path = os.path.join(tmp, f"train.{fmt}")
            t0 = time.perf_counter()
            write_data_file(path, X, y, fmt)
            size = os.path.getsize(path)
            files[fmt] = {"bytes": size,
                          "write_s": time.perf_counter() - t0}
            variants = [(fmt, {})]
            if fmt == "csv":
                variants += [("csv_two_round", {"two_round": True}),
                             ("csv_two_round_store",
                              {"two_round": True, "external_memory": True,
                               "datastore_dir": tmp})]
            for name, extra in variants:
                fb, frec, times = _file_run(path, dict(params, **extra),
                                            modules, rounds)
                add(_wave_counters(modules))
                same = fb.model_to_string() == text if not extra else \
                    _without_params(fb.model_to_string()) \
                    == _without_params(text)
                _check(same, f"train_files: {name}'s model differs from "
                       "the array's")
                _check(_k23(frec) == k23, f"train_files: {name}'s K2/K3 "
                       f"launches {_k23(frec)} != the array's {k23}")
                if times["parse_s"]:
                    times["parse_mb_per_s"] = size / times["parse_s"] / 1e6
                runs[name] = dict(times, model_text_identical=True)
            if fmt == "csv":
                # predictions from the file, its label column dropped
                host = fb.predict(path, raw_score=True)
                host_arr, walk, pred = _host_walks(fb, X)
                _check(_bits_equal(host, host_arr)
                       and _bits_equal(host, walk),
                       "train_files: predict(csv) != the array's or the "
                       "numpy walk")
                dev = fb.predict(path, device_predict=True)
                _check(_bits_equal(dev, fb.predict(X, device_predict=True)),
                       "train_files: device_predict(csv) != the array's")
            os.unlink(path)
        # ---- the host walk at the served sizes: the main phase's
        # forest, the library's walk against numpy's
        from lightgbm_tpu_torch import Booster
        forest = Booster(model_str=synthetic_forest_text(seed))
        Xs = request_rows(np.random.RandomState(seed + 2),
                          HOST_WALK_ROWS[-1])
        forest.predict(Xs[:1], raw_score=True)
        report["host_walk_main_model"] = {
            str(n): _host_walks(forest, Xs[:n])[2] for n in HOST_WALK_ROWS}
        del forest
        report["file_set"] = {"rows": rows, "features": X.shape[1],
                              "rounds": rounds, "files": files,
                              "array_k2_k3_per_round": k23,
                              "runs": runs, "predict_bitwise": True,
                              "host_walk": pred}

        # ---- external memory: the 2M rows, in memory (the train
        # phase's Dataset, binned as the bench bins) and spilled
        wparams = dict(EXT_PARAMS)
        if device is not None:
            wparams["device_type"] = device
        _zero_wave_counters(modules)
        mem, mrec = _wave_run(wparams, data.dataset, modules, rounds, False)
        add(_wave_counters(modules))
        mtext, mk23 = mem.model_to_string(), _k23(mrec)
        ext = {"in_memory_ms_per_round_2_on":
               float(np.mean(mrec["round_s"][1:])) * 1e3,
               "in_memory_round_1_ms": float(mrec["round_s"][0]) * 1e3}
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=pcie.link.gen.current,"
             "pcie.link.width.current", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        ext["pcie_link_gen_width"] = smi.stdout.strip()
        spilled = None
        for name, extra in (("default_budget", {}),
                            ("shards_65536", {
                                "datastore_shard_rows": EXT_SHARD_ROWS,
                                "datastore_prefetch": EXT_PREFETCH})):
            spilled, sb, srec, figs = _spilled_run(
                data.X, data.y, dict(wparams, **extra), modules, rounds,
                os.path.join(tmp, name))
            add(_wave_counters(modules))
            _check(_without_params(sb.model_to_string())
                   == _without_params(mtext),
                   f"train_files: the {name} spilled model differs")
            _check(_k23(srec) == mk23, f"train_files: {name}'s K2/K3 "
                   f"launches {_k23(srec)} != in memory {mk23}")
            ext[name] = dict(figs, model_text_identical=True)
        _check(ext["shards_65536"]["shards"] == -(-len(data.X)
                                                   // EXT_SHARD_ROWS),
               "train_files: the 65536-row store's shard count")

        # ---- tamper: a flipped byte, the store read anew
        store = spilled.datastore
        shard = os.path.join(store.dirpath, "shard-00003.bins")
        with open(shard, "r+b") as fh:
            fh.seek(1000)
            b = fh.read(1)
            fh.seek(1000)
            fh.write(bytes([b[0] ^ 0xFF]))
        spilled.datastore = ShardStore.open(store.dirpath)
        try:
            lt.train(dict(wparams, external_memory=True), spilled, 1)
            _check(False, "train_files: a flipped shard byte trained")
        except lt.LightGBMError as e:
            _check(shard in str(e) and "checksum" in str(e),
                   f"train_files: the tamper raised {e}")
        ext["tamper_raises_naming_the_file"] = True
        report["external_memory"] = ext
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {"histogram": counts["k1"], "fused_hist_split": counts["k2"],
                "split_scan": counts["k3"], "histogram_q": counts["k4"],
                "fused_hist_split_q": counts["k5"]}
    report["launches"] = launches
    report["phase_s"] = time.perf_counter() - t_phase
    _emit(report)
    return launches


# ------------------------------------------------------- train_stream
#: the carry kernels' check: the first rows of the bench's bins, cut
#: into 7 uneven shards (batches and pieces straddle the cuts), and the
#: slot counts (the wave's 8 live smaller children at most)
STREAM_CARRY_ROWS = 200_000
STREAM_CUTS = (17_000, 45_000, 46_000, 90_000, 131_072, 170_001)
STREAM_SLOTS = (1, 3, 8)
#: the carries at the shapes their paths run, on the bench's 2M rows:
#: (name, slots, rows a shard) -- the streamed grower's shards of 65,536
#: rows at S = 1 (the root: every row) and S = 8 (a depth-3 partition),
#: and the data learner's ring of two ranks, a fold of 1M rows at S = 8
CARRY_FOLD_ROWS = 1_000_000
CARRY_SHAPES = (("shard_65536_s1", 1, 65536), ("shard_65536_s8", 8, 65536),
                ("fold_1m_s8", 8, CARRY_FOLD_ROWS))
#: streamed training: the bench's 2M rows in 31 shards of 65,536 rows;
#: the budget the 56,000,000 B of bins exceed
STREAM_SHARD_ROWS = 65536
STREAM_BUDGET_MB = 16
#: (name, params, streaming_train, rounds): the bench's wave under
#: "auto" over the budget, leafwise strict and the quantized wave "on"
STREAM_RUNS = (("wave", WAVE_PARAMS, "auto", 5),
               ("strict", dict(TRAIN_PARAMS, num_leaves=31), "on", 2),
               ("quant_wave", QUANT_PARAMS, "on", 3))
#: the pass stages of `streaming/engine.py`, in its histograms' names
STREAM_STAGES = ("prefetch_wait", "h2d", "device_fold", "host_harvest")


def _carry_bytes(f, n, rows_in, s, mb, row_bytes):
    """Bytes one shard's fold must move: every leaf id of its n rows,
    the u8 bins of its `rows_in` rows in the slots and their payload of
    `row_bytes` (f32: 12 B, the int8 lattice: 3 B), the carried [S, F,
    MB, 3] cells (4 B each) read and written."""
    return n * 4 + rows_in * (f + row_bytes) + 2 * s * f * mb * 12


def _fresh_ms(run, make, iters=10, queued=True):
    """Mean ms of run(state) over `iters` states, each made by make()
    before the events record (a carry's init is outside the timed
    runs); with `queued`, the runs wait behind a spin kernel as
    `_cuda_ms`'s do, so the events read device time."""
    import torch
    run(make())
    torch.cuda.synchronize()
    cycles = 2_000_000
    while True:
        states = [make() for _ in range(iters)]
        torch.cuda.synchronize()
        if queued:
            torch.cuda._sleep(cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for st in states:
            run(st)
        end.record()
        ahead = not start.query()
        torch.cuda.synchronize()
        if not queued or ahead:
            return start.elapsed_time(end) / iters
        _check(cycles < 1 << 34, "timing: the runs could not be queued "
               "ahead of the card")
        cycles *= 4


def _fresh_iters(shards):
    """Passes `_fresh_ms` times for a carry of `shards` shards: at most
    about 120 shards' launches queued behind the spin kernel (the card's
    queue holds about a thousand launches, and an older carry makes four
    a shard)."""
    return max(2, min(10, 120 // shards))


def _profile_kernels(fn):
    """One fn() under torch.profiler: {kernel: [device ms, launches
    seen]}, a kernel named without its namespace, template and
    arguments, and under "launch_calls" the runtime's kernel-launch
    calls.  The tracer may miss some kernels' device records (seen on
    the H100 host), so the launch calls count the kernels and a kernel's
    device ms over its launches seen is its mean."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out, calls = {}, 0
    for e in prof.events():
        if e.name.startswith("cudaLaunchKernel"):
            calls += 1
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        key = e.name.split("(anonymous namespace)::")[-1]
        key = key.split("<")[0].split("(")[0]
        ms, k = out.get(key, (0.0, 0))
        out[key] = (ms + e.time_range.elapsed_us() / 1e3, k + 1)
    out = {k: [v[0], v[1]] for k, v in out.items()}
    out["launch_calls"] = calls
    return out


def _carry_fns(hk, hkq, blocks, f, n, sl, mb, lengths, q, quantized):
    """(make, run, finalize) of one carry over `blocks` (the shards'
    (bins, payload, leaf ids, lattice)), with `hk` and `hkq` the port's
    carry modules (this checkout's or another's): make() a fresh carry,
    run(carry) folds every shard into it, finalize(carry) its
    histogram."""
    if quantized:
        def run(c):
            for bb, _, ll, pp in blocks:
                hkq.histogram_carry_q_update(c, bb, pp, ll)
            return c
        return (lambda: hkq.histogram_carry_q_init(f, sl, mb), run,
                lambda c: hkq.histogram_carry_q_finalize(c, q["sg"],
                                                         q["sh"]))

    def run(c):
        for bb, pl, ll, _ in blocks:
            hk.histogram_carry_update(c, bb, pl, ll)
        return c
    return (lambda: hk.histogram_carry_init(n, f, sl, mb, lengths), run,
            hk.histogram_carry_finalize)


def _carry_plain(blocks, f, sl, mb, q, quantized):
    """The carry's plain version over `blocks` (`ops/histogram.py
    hist_stream_*`; the int32 carry's `carry_q_plain_update` in int64):
    a function that folds every shard and returns the histogram."""
    import torch
    from lightgbm_tpu_torch.ops import hist_kernel_q as hkq
    from lightgbm_tpu_torch.ops import histogram as ph
    s, dev = sl.shape[0], sl.device

    def plain():
        if quantized:
            acc = torch.zeros((s, f, mb, 3), dtype=torch.int64, device=dev)
            for bb, _, ll, pp in blocks:
                hkq.carry_q_plain_update(acc, bb, pp, ll, sl, mb)
            return hkq.dequantize(acc, q["sg"], q["sh"])
        acc = ph.hist_stream_init(f, s, mb, device=dev)
        for bb, pl, ll, _ in blocks:
            ph.hist_stream_update(acc, bb, pl, ll, sl, mb)
        return ph.hist_stream_finalize(acc, s, mb)
    return plain


def _carry_library(blocks, f, mb, quantized):
    """One `index_add_` a shard of every row's bins and payload (or
    lattice) into [F * MB, 3] cells: the library's call for the same
    adds (a slot of every row)."""
    import torch
    flat = [(bb.to(torch.int64) + torch.arange(
        f, device=bb.device)[:, None] * mb).reshape(-1)
        for bb, _, _, _ in blocks]
    vals = [(pp.t().to(torch.int64) if quantized else pl).repeat(f, 1)
            for _, pl, _, pp in blocks]
    acc = torch.zeros((f * mb, 3), device=flat[0].device,
                      dtype=vals[0].dtype)

    def library():
        for fl, vv in zip(flat, vals):
            acc.index_add_(0, fl, vv)
    return library


def _carry_times(make, run, library, shards, nbytes, profile=False):
    """A shard's fold timed on the card: device ms (behind a spin kernel,
    the carries made outside the timed passes), the host's pace, the
    library call's device ms, the bound of `nbytes` a shard; with
    `profile`, the kernels of one pass by the profiler and their
    launches a shard."""
    iters = _fresh_iters(shards)
    out = {"ms": _fresh_ms(run, make, iters) / shards,
           "host_ms": _fresh_ms(run, make, iters, queued=False) / shards,
           "library_ms": _cuda_ms(library, iters=5, queued=True) / shards,
           "bytes_per_shard": nbytes}
    out["bound_ms"], out["bound_by"] = _bound(nbytes, 0, 1)
    if profile:
        c = make()
        kernels = _profile_kernels(lambda: run(c))
        out["kernels"] = kernels
        out["kernels_per_shard"] = kernels["launch_calls"] / shards
    return out


def _carry_case(data, seed, dev, timing, quantized):
    """One carry entry at S = 1, 3 and 8 slots of a depth-3 partition of
    the first STREAM_CARRY_ROWS rows of the bench's bins, in the shards
    of STREAM_CUTS: gates the f32 carry bitwise `histogram_carry_ordered`
    and `histogram_multi` (K1) over all rows, and within K1's tolerance
    (1e-4 * sum|x| + 1e-6 a cell) of its plain carry on the card; the
    int32 carry bitwise K4 over all rows and its plain carry; two folds
    bitwise.  A shard's fold (a pass of the 7 over fresh carries,
    divided by 7) timed as device time and at the host's pace beside its
    bound, the plain carry (host pace) and one `index_add_` a shard
    (device time); at S = 8 the profiler's kernels a shard.  Then the
    shapes the paths run (`_carry_sizes`).  Each case's report."""
    import torch
    from lightgbm_tpu_torch.ops import hist_kernel as hk
    from lightgbm_tpu_torch.ops import hist_kernel_q as hkq
    from lightgbm_tpu_torch.ops import histogram as ph
    n = min(STREAM_CARRY_ROWS, len(data.y))
    cuts = [c for c in STREAM_CUTS if c < n]
    edges = [0] + cuts + [n]
    shards = list(zip(edges[:-1], edges[1:]))
    bnp = np.ascontiguousarray(data.dataset.bin_data[:n].T)
    f, mb = bnp.shape[0], 255
    lid_np = _partition(bnp, 3)
    q = _quant_inputs(bnp, data.y[:n], lid_np, [0], seed, dev)
    bins, pay, lid, pw3 = q["bins"], q["pay"], q["lid"], q["pw3"]
    cases = {}
    for s in STREAM_SLOTS:
        sl = torch.arange(s, dtype=torch.int32, device=dev)
        lengths = torch.tensor([int((lid_np == k).sum()) for k in range(s)],
                               dtype=torch.int32, device=dev)
        blocks = [(bins[:, a:b].contiguous(), pay[a:b], lid[a:b],
                   pw3[:, a:b].contiguous()) for a, b in shards]
        make, run, finalize = _carry_fns(hk, hkq, blocks, f, n, sl, mb,
                                         lengths, q, quantized)

        plain = _carry_plain(blocks, f, sl, mb, q, quantized)

        def fold():
            return finalize(run(make()))

        got = fold()
        _check(_bits_equal(got.cpu(), fold().cpu()),
               f"train_stream: two folds differ at S = {s}")
        p = plain()
        if quantized:
            want = hkq.histogram_multi_quantized(bins, pw3, lid, sl, mb,
                                                 q["sg"], q["sh"])
            _check(_bits_equal(got.cpu(), want.cpu()),
                   f"train_stream: the int32 carry != K4 over all rows at "
                   f"S = {s}")
            _check(_bits_equal(got.cpu(), p.cpu()), "train_stream: the "
                   f"int32 carry != its plain carry at S = {s}")
        else:
            want = hk.histogram_multi(bins, pay, lid, sl, mb)
            if dev.type == "cuda":      # the kernel's order (the CPU
                ordered = hk.histogram_carry_ordered(     # runs the plain
                    bins.cpu(), pay.cpu(), lid.cpu(), sl.cpu(), mb, cuts)
                _check(_bits_equal(got.cpu(), ordered),   # carry)
                       f"train_stream: the f32 carry != its ordered model "
                       f"at S = {s}")
            _check(_bits_equal(got.cpu(), want.cpu()), "train_stream: the "
                   f"f32 carry != K1 over all rows at S = {s}")
            absx = ph.hist_stream_finalize(ph.hist_stream_update(
                ph.hist_stream_init(f, s, mb, device=dev), bins, pay.abs(),
                lid, sl, mb), s, mb)
            _check(bool(((got - p).abs() <= 1e-4 * absx + 1e-6).all()),
                   f"train_stream: the f32 carry outside K1's tolerance of "
                   f"its plain carry at S = {s}")
        case = {"slots": s, "rows": n, "shards": len(shards),
                "bitwise_model_and_over_all_rows": True,
                "max_abs_err": _max_abs_err(got.cpu(), p.cpu())}
        if timing:
            rows_in = [int((lid_np[a:b] < s).sum()) for a, b in shards]
            nbytes = sum(_carry_bytes(f, b - a, r, s, mb,
                                      3 if quantized else 12)
                         for (a, b), r in zip(shards, rows_in)) / len(shards)
            case.update(_carry_times(
                make, run, _carry_library(blocks, f, mb, quantized),
                len(shards), nbytes, profile=s == STREAM_SLOTS[-1]),
                plain_ms=_cuda_ms(plain, iters=3) / len(shards))
        cases[f"s{s}"] = case
    if not quantized and dev.type == "cuda":
        cases["edges"] = {"cases": _carry_edges(seed, dev),
                          "bitwise_model_and_over_all_rows": True}
    if timing:
        cases.update(_carry_sizes(data, seed, dev, quantized))
    return cases


#: the f32 carry's edge cases: (rows, features, max_bin, slots, shard
#: cuts) -- single-row shards and a slot absent from many shards, u16
#: bins with out-of-range codes, repeated slots, more than 14 slots
CARRY_EDGES = ((24_000, 3, 63, (0, 2, 0, 5), "single"),
               (20_000, 2, 700, (1, 0, 3), "u16"),
               (30_000, 2, 255, tuple(range(17)), "wide"))


def _carry_edges(seed, dev):
    """The f32 carry on small random inputs (CARRY_EDGES) bitwise its
    order-exact model (`histogram_carry_ordered`, on the CPU) and K1 over
    all rows; the number of cases."""
    import torch
    from lightgbm_tpu_torch.ops import hist_kernel as hk
    rng = np.random.default_rng(seed)
    for n, f, mb, slots, kind in CARRY_EDGES:
        dtype = np.uint16 if mb > 255 else np.uint8
        bins = rng.integers(0, mb + (kind == "u16"), (f, n)).astype(dtype)
        lid = rng.integers(0, max(slots) + 2, n).astype(np.int32)
        lid[n // 3:2 * n // 3] = slots[-1]       # shards without the others
        pay = rng.standard_normal((n, 3)).astype(np.float32)
        cuts = sorted({int(c) for c in rng.integers(1, n, 40)}
                      | {1, 2, 3, n // 2, n // 2 + 1})
        B, P, L = (torch.from_numpy(x) for x in (bins, pay, lid))
        sl = torch.tensor(slots, dtype=torch.int32)
        want = hk.histogram_carry_ordered(B, P, L, sl, mb, cuts)
        lengths = torch.tensor([int((lid == v).sum()) for v in slots],
                               dtype=torch.int32, device=dev)
        c = hk.histogram_carry_init(n, f, sl.to(dev), mb, lengths)
        edges = [0] + cuts + [n]
        for a, b in zip(edges[:-1], edges[1:]):
            hk.histogram_carry_update(c, B[:, a:b].contiguous().to(dev),
                                      P[a:b].to(dev), L[a:b].to(dev))
        got = hk.histogram_carry_finalize(c).cpu()
        k1 = torch.cat([hk.histogram_multi(
            B.to(dev), P.to(dev), L.to(dev), sl[c0:c0 + 14].to(dev),
            mb).cpu() for c0 in range(0, len(slots), 14)])
        _check(_bits_equal(got, want) and _bits_equal(got, k1),
               f"train_stream: the f32 carry's {kind} case != its ordered "
               "model or K1 over all rows")
    return len(CARRY_EDGES)


def _carry_sizes(data, seed, dev, quantized):
    """The carry at the shapes its paths run, on the bench's 2M rows
    (CARRY_SHAPES): a pass over the 2M rows in shards of
    STREAM_SHARD_ROWS (the streamed grower's; a shard's mean), and one
    fold of the first CARRY_FOLD_ROWS rows (rank 0's part of the data
    learner's ring), each slot's L over all 2M rows; timed as
    `_carry_times`, the profiler's kernels a shard.  Gates the 2M pass
    bitwise K1 (K4) over all rows, and the ring's two folds too."""
    import torch
    from lightgbm_tpu_torch.ops import hist_kernel as hk
    from lightgbm_tpu_torch.ops import hist_kernel_q as hkq
    n = len(data.y)
    bnp = np.ascontiguousarray(data.dataset.bin_data.T)
    f, mb = bnp.shape[0], 255
    lid3 = _partition(bnp, 3)
    q = _quant_inputs(bnp, data.y, lid3, [0], seed, dev)
    bins, pay, pw3 = q["bins"], q["pay"], q["pw3"]
    out = {}
    for name, s, step in CARRY_SHAPES:
        lid_np = lid3 if s > 1 else np.zeros(n, np.int32)
        lid = q["lid"] if s > 1 else torch.zeros(n, dtype=torch.int32,
                                                 device=dev)
        sl = torch.arange(s, dtype=torch.int32, device=dev)
        lengths = torch.tensor([int((lid_np == k).sum()) for k in range(s)],
                               dtype=torch.int32, device=dev)
        edges = list(range(0, n, step)) + [n]
        blocks = [(bins[:, a:b].contiguous(), pay[a:b], lid[a:b],
                   pw3[:, a:b].contiguous())
                  for a, b in zip(edges[:-1], edges[1:])]
        make, run, finalize = _carry_fns(hk, hkq, blocks, f, n, sl, mb,
                                         lengths, q, quantized)
        got = finalize(run(make()))
        want = hkq.histogram_multi_quantized(bins, pw3, lid, sl, mb,
                                             q["sg"], q["sh"]) \
            if quantized else hk.histogram_multi(bins, pay, lid, sl, mb)
        _check(_bits_equal(got.cpu(), want.cpu()), f"train_stream: the "
               f"{'int32' if quantized else 'f32'} carry over {name}'s "
               f"shards != {'K4' if quantized else 'K1'} over all rows")
        timed = blocks[:1] if step == CARRY_FOLD_ROWS else blocks
        make, run, _ = _carry_fns(hk, hkq, timed, f, n, sl, mb, lengths, q,
                                  quantized)
        sizes = [bb.shape[1] for bb, _, _, _ in timed]
        rows_in = [int((lid_np[a:a + r] < s).sum()) for a, r in
                   zip(edges, sizes)]
        nbytes = sum(_carry_bytes(f, r, i, s, mb, 3 if quantized else 12)
                     for r, i in zip(sizes, rows_in)) / len(timed)
        plain = _carry_plain(timed, f, sl, mb, q, quantized)
        out[name] = dict(slots=s, rows=n, shard_rows=step,
                         timed_shards=len(timed),
                         plain_ms=_cuda_ms(plain, iters=2) / len(timed),
                         **_carry_times(make, run, _carry_library(
                             timed, f, mb, quantized), len(timed), nbytes,
                             profile=True))
    return out


def _cand_gate(fused_module, quantized):
    """A wrapper over K2 (`quantized`: K5) as the wave grower calls it
    that holds K3's candidates on the kernel's histogram, with the
    parent sums it was given, bitwise the kernel's own; and the count
    of calls it checked."""
    real = getattr(fused_module, "fused_hist_split_quantized" if quantized
                   else "fused_hist_split")
    seen = [0]

    def call(*a, **kw):
        hist, cand = real(*a, **kw)
        k3 = fused_module.split_scan(hist, a[4], a[5], a[6], **kw)
        _check(_bits_equal(k3.cpu(), cand.cpu()), "train_stream: K3's "
               "candidates on "
               f"{'K5' if quantized else 'K2'}'s histogram differ from "
               "its own")
        seen[0] += 1
        return hist, cand

    return call, seen


def _stage_sums():
    from lightgbm_tpu_torch.telemetry import REGISTRY
    return {k: (REGISTRY.histogram(f"stream.pass.{k}").sum,
                REGISTRY.histogram(f"stream.pass.{k}").count)
            for k in STREAM_STAGES + ("wall",)}


def _rounds_ms(params, ds, rounds, sync):
    """A training run with its rounds' host milliseconds."""
    import lightgbm_tpu_torch as lt
    marks = []

    def mark(env):
        sync()
        marks.append(time.perf_counter())

    t0 = time.perf_counter()
    bst = lt.train(params, ds, num_boost_round=rounds, callbacks=[mark])
    return bst, np.diff([t0] + marks) * 1e3


def phase_train_stream(data: TrainData, modules, device=None,
                       timing: bool = True):
    """The shard-streamed grower and the memory ledger (ROADMAP Queue 1
    item 5e's second half and item 5g's ledger) on the card.  The carry
    entries against their models (`_carry_case`).  Then the bench's 2M
    rows spilled in 31 shards of 65,536 rows and trained three ways
    (STREAM_RUNS), each against the in-memory model trained here on the
    train phase's Dataset: gates the model text byte for byte (less the
    parameter lines), the streamed grower engaged and the bins never
    assembled, the staging within STREAM_BUDGET_MB, the streamed run's
    peak allocation below the in-memory run's by half the bins' bytes at
    least; in memory, K3's candidates on K2's (K5's) histograms bitwise
    the kernel's own (the streamed smaller children's come from K3).
    Reports round ms both ways, sweeps of the store a tree, the carry's
    and K3's launches a round, the four pass stages, the store's read
    rate, the prefetch hits and stalls.  After the wave run the ledger's
    reconcile against `torch.cuda.memory_stats` and its owners.  Returns
    the kernels-line entries of the two carry entries, their launches
    the streamed runs'."""
    import gc
    import shutil
    import tempfile
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import grow_wave
    from lightgbm_tpu_torch.ops import hist_kernel as hk
    from lightgbm_tpu_torch.ops import hist_kernel_q as hkq
    from lightgbm_tpu_torch.streaming import engine
    from lightgbm_tpu_torch.telemetry import MEMLEDGER, REGISTRY
    t_phase = time.perf_counter()
    dev = torch.device(device or "cuda")
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    report = {"phase": "train_stream"}
    t0 = time.perf_counter()
    carry = _carry_case(data, 0, dev, timing and cuda, False)
    carry_q = _carry_case(data, 0, dev, timing and cuda, True)
    report["carry"], report["carry_q"] = carry, carry_q
    report["carry_check_s"] = time.perf_counter() - t0

    tmp = tempfile.mkdtemp(prefix="train_stream_")
    fused = modules["fused"]
    try:
        sparams = dict(TRAIN_PARAMS, external_memory=True,
                       datastore_shard_rows=STREAM_SHARD_ROWS,
                       datastore_dir=tmp)
        t0 = time.perf_counter()
        sds = lt.Dataset(data.X, label=data.y, params=sparams).construct()
        store = sds.datastore
        bins_bytes = store.total_bytes("bins")
        report["store"] = {"shards": store.n_shards,
                           "shard_rows": store.shard_rows,
                           "bins_bytes": bins_bytes,
                           "construct_s": time.perf_counter() - t0}
        _check(store.n_shards == -(-len(data.y) // STREAM_SHARD_ROWS)
               and bins_bytes > STREAM_BUDGET_MB * 2 ** 20,
               f"train_stream: the store {report['store']}")
        launches = {"histogram_carry": 0, "histogram_carry_q": 0}
        runs = {}
        for name, params, mode, rounds in STREAM_RUNS:
            params = dict(params)
            if device is not None:
                params["device_type"] = device
            quant = bool(params.get("use_quantized_grad"))
            # ---- in memory, K3 held to K2's (K5's) candidates
            attr = "fused_hist_split_quantized" if quant \
                else "fused_hist_split"
            gate, checked = _cand_gate(fused, quant)
            real = getattr(grow_wave, attr)
            setattr(grow_wave, attr, gate)
            gc.collect()
            if cuda:
                torch.cuda.reset_peak_memory_stats(dev)
            try:
                mem, mem_ms = _rounds_ms(params, data.dataset, rounds, sync)
            finally:
                setattr(grow_wave, attr, real)
            mem_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
            mem_text = _without_params(mem.model_to_string())
            wave = params.get("tree_grow_policy") == "wave"
            _check(checked[0] > 0 or not wave, f"train_stream: {name}: no "
                   "K2/K5 launch was checked against K3")
            del mem
            gc.collect()
            # ---- streamed
            hk.HIST_CARRY_LAUNCHES = hkq.HIST_CARRY_Q_LAUNCHES = 0
            k3_0 = fused.SCAN_LAUNCHES
            sweeps0 = dict(engine.SWEEPS)
            stages0 = _stage_sums()
            REGISTRY.gauge("stream.peak_staging_mb").set(0.0)
            if cuda:
                torch.cuda.reset_peak_memory_stats(dev)
            st, st_ms = _rounds_ms(dict(
                params, external_memory=True, streaming_train=mode,
                datastore_budget_mb=STREAM_BUDGET_MB), sds, rounds, sync)
            st_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
            carry_l = hk.HIST_CARRY_LAUNCHES
            carry_q_l = hkq.HIST_CARRY_Q_LAUNCHES
            k3 = fused.SCAN_LAUNCHES - k3_0
            eng = st._streaming
            _check(eng is not None and st._dd._bins_fm is None
                   and sds.bin_data is None,
                   f"train_stream: {name} did not stream")
            _check(_without_params(st.model_to_string()) == mem_text,
                   f"train_stream: {name}'s streamed model differs from "
                   "the in-memory one")
            staging = REGISTRY.gauge("stream.peak_staging_mb").value
            _check(0 < staging <= STREAM_BUDGET_MB,
                   f"train_stream: {name}: staging {staging} MB")
            _check(not cuda or st_peak <= mem_peak - bins_bytes // 2,
                   f"train_stream: {name}: peak {st_peak} B streamed vs "
                   f"{mem_peak} B in memory")
            _check(not cuda or (carry_q_l if quant else carry_l) > 0,
                   f"train_stream: {name} launched no carry kernel")
            trees = len(st.trees)
            sweeps = {k: engine.SWEEPS[k] - sweeps0[k]
                      for k in engine.SWEEPS}
            stages1 = _stage_sums()
            stage_s = {k: stages1[k][0] - stages0[k][0]
                       for k in STREAM_STAGES + ("wall",)}
            passes = stages1["wall"][1] - stages0["wall"][1]
            launches["histogram_carry"] += carry_l
            launches["histogram_carry_q"] += carry_q_l
            runs[name] = {
                "rounds": rounds, "streaming_train": mode,
                "model_text_identical": True,
                "in_memory_round_ms": mem_ms.tolist(),
                "streamed_round_ms": st_ms.tolist(),
                "sweeps_per_tree": sum(sweeps.values()) / trees,
                "sweeps_by_phase": sweeps,
                "carry_launches_per_round":
                    (carry_q_l if quant else carry_l) / rounds,
                "k3_launches_per_round": k3 / rounds,
                "k2_k5_checked_against_k3": checked[0],
                "pass_stage_s": stage_s, "passes": passes,
                "store_gb_per_s": passes * bins_bytes / stage_s["wall"]
                / 1e9 if stage_s["wall"] else None,
                "prefetch_hits": eng.stats.hits,
                "prefetch_stalls": eng.stats.stalls,
                "peak_staging_mb": staging,
                "peak_device_mb": REGISTRY.gauge(
                    "stream.peak_device_mb").value,
                "in_memory_peak_allocated": mem_peak,
                "streamed_peak_allocated": st_peak}
            if name == "wave":
                rec = MEMLEDGER.reconcile()
                owners = MEMLEDGER.snapshot()["devices"].get(
                    f"dev{dev.index or 0}" if cuda else "host", {}).get(
                    "owners", {})
                seen = {k.split("{")[0] for k, v in owners.items()
                        if v["peak_bytes"] > 0}
                _check(not cuda or rec["source"] == "memory_stats",
                       f"train_stream: reconcile {rec['source']}")
                _check({"train.scores", "train.hist_carry"} <= seen,
                       f"train_stream: the ledger's owners {sorted(seen)}")
                runs[name]["ledger"] = {"reconcile": rec,
                                        "owners": owners}
            del st
            gc.collect()
        report["runs"] = runs
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    report["launches"] = launches
    report["phase_s"] = time.perf_counter() - t_phase
    _emit(report)
    entries = []
    for name, src, line, cases in (
            ("histogram_carry", "histogram.cu", 85, carry),
            ("histogram_carry_q", "histogram_q.cu", 171, carry_q)):
        top = cases[f"s{STREAM_SLOTS[-1]}"]
        entries.append({
            "name": name, "route": "cuda",
            "source": f"lightgbm_tpu_torch/csrc/{src}",
            "replaces": f"lightgbm_tpu/ops/pallas_hist.py:{line}",
            "launches": launches[name],
            "max_abs_err": max(c.get("max_abs_err", 0.0)
                               for c in cases.values()),
            **{k: top.get(k) for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")},
            "cases": cases})
    return entries


# ------------------------------------------------------------ train_dist
#: ranks of the distributed phase: gloo processes sharing the one card
DIST_WORLD = 2
#: the voting runs' local top_k: 2 top_k = 20 of the 28 features elected
DIST_TOP_K = 10
#: the serial card models the distributed runs are held to: (params,
#: rounds)
DIST_SERIAL = {"wave": (WAVE_PARAMS, 5), "quant_wave": (QUANT_PARAMS, 3),
               "strict": (dict(TRAIN_PARAMS, num_leaves=31), 2)}
#: (name, learner, serial run, gate): the two ranks' runs, at the serial
#: run's params and rounds; "bitwise" holds the model text to the serial
#: card model's byte for byte (less the parameter lines), "auc" the
#: held-out AUC within DIST_AUC_TOL of it
DIST_RUNS = (("data_wave", "data", "wave", "bitwise"),
             ("data_quant_wave", "data", "quant_wave", "bitwise"),
             ("data_strict", "data", "strict", "bitwise"),
             ("feature", "feature", "strict", "bitwise"),
             ("voting", "voting", "strict", "auc"))
DIST_AUC_TOL = 1e-3
#: most bytes a hop of the f32 carry may move at S <= 8 slots of 28
#: features and 255 bins: its prefix and open piece (2 x 685,440 B), the
#: ranks, the open batch's rows and the parity
DIST_HOP_BYTES = 1_500_000
#: seconds the ranks may take together
DIST_TIMEOUT_S = 900


def _dist_counters():
    from lightgbm_tpu_torch.ops import fused_kernel, hist_kernel, \
        hist_kernel_q, xla_math
    return {"histogram": hist_kernel.HIST_LAUNCHES,
            "histogram_carry": hist_kernel.HIST_CARRY_LAUNCHES,
            "histogram_q": hist_kernel_q.HIST_Q_LAUNCHES,
            "histogram_carry_q": hist_kernel_q.HIST_CARRY_Q_LAUNCHES,
            "fused_hist_split": fused_kernel.FUSED_LAUNCHES,
            "fused_hist_split_q": fused_kernel.FUSED_Q_LAUNCHES,
            "split_scan": fused_kernel.SCAN_LAUNCHES,
            "xla_link": xla_math.LINK_LAUNCHES}


def _zero_dist_counters():
    from lightgbm_tpu_torch.ops import fused_kernel, hist_kernel, \
        hist_kernel_q, xla_math
    hist_kernel.HIST_LAUNCHES = hist_kernel.HIST_CARRY_LAUNCHES = 0
    hist_kernel_q.HIST_Q_LAUNCHES = hist_kernel_q.HIST_CARRY_Q_LAUNCHES = 0
    fused_kernel.FUSED_LAUNCHES = fused_kernel.FUSED_Q_LAUNCHES = 0
    fused_kernel.SCAN_LAUNCHES = 0
    xla_math.LINK_LAUNCHES = 0


def _dist_params(learner, serial, device=None):
    params, rounds = DIST_SERIAL[serial]
    p = dict(params, tree_learner=learner, memory_ledger=True)
    if device is not None:
        p["device_type"] = device
    if learner == "voting":
        p["top_k"] = DIST_TOP_K
    return p, rounds


def dist_worker(rank: int, world: int, store: str, job_path: str) -> int:
    """One rank of the train_dist phase (`--dist-worker`): joins the gloo
    group through the file store, loads the job's `save_binary` file, and
    trains each run on the card (the device every rank shares), its
    launches counted from 0 just before and read just after; writes each
    model text and one JSON report beside the job."""
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch import mesh
    from lightgbm_tpu_torch.telemetry import MEMLEDGER
    with open(job_path) as f:
        job = json.load(f)
    cuda = job["device"] is None
    if not cuda:
        torch.set_num_threads(1)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    mesh.init(f"file://{store}", world, rank, backend="gloo",
              timeout_ms=job["timeout_ms"])
    t0 = time.perf_counter()
    ds = lt.Dataset.load_binary(job["data"])
    report = {"rank": rank, "load_s": time.perf_counter() - t0, "runs": {}}
    for name, learner, serial, _ in DIST_RUNS:
        params, rounds = _dist_params(learner, serial, job["device"])
        _zero_dist_counters()
        mesh.reset_stats()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        bst, ms = _rounds_ms(params, ds, rounds, sync)
        wall = time.perf_counter() - t0
        launches = _dist_counters()
        stats = {k: dict(v) for k, v in mesh.STATS.items()}
        with open(os.path.join(job["out"], f"{name}.r{rank}.txt"),
                  "w") as f:
            f.write(bst.model_to_string())
        report["runs"][name] = {
            "round_ms": ms.tolist(), "wall_s": wall, "launches": launches,
            "collectives": stats, "trees": len(bst.trees),
            "peak_allocated": torch.cuda.max_memory_allocated()
            if cuda else None,
            "ledger_peak_bytes": MEMLEDGER.snapshot()["devices"].get(
                f"dev{torch.cuda.current_device()}" if cuda else "host",
                {}).get("peak_bytes")}
        del bst
    with open(os.path.join(job["out"], f"report.r{rank}.json"), "w") as f:
        json.dump(report, f)
    mesh.shutdown()
    return 0


def _compute_mode() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def _stage_totals(stats):
    """The seconds of the D2H copies, the collectives and the H2D copies
    summed over a rank's collectives, and their calls and bytes."""
    return {k: sum(v[k] for v in stats.values())
            for k in ("d2h_s", "comm_s", "h2d_s", "calls", "bytes")}


def phase_train_dist(data: TrainData, device=None):
    """Distributed training (ROADMAP Queue 1 item 5f) on the card: two
    gloo ranks, processes of this script (`--dist-worker`), both on the
    one GPU, each holding half of the train phase's 2M rows.  The parent
    writes the Dataset with `save_binary`, which every rank loads, trains
    the serial card models (DIST_SERIAL), then runs the ranks (DIST_RUNS):
    the bench's wave with `tree_learner=data` (the ring of f32 carries,
    K3 over the finalized histograms), the quantized wave (the int32
    carries summed), strict at 31 leaves, the feature learner (K1 on a
    rank's block under the whole matrix's plan) and voting (top_k 10).
    Gates: every run's two ranks agree; data and feature model texts the
    serial card model's byte for byte (less the parameter lines); voting's
    held-out AUC within 1e-3 of the serial strict model's; the carry
    kernels launched on each rank; a hop of the f32 carry at most
    DIST_HOP_BYTES.  Reports round ms beside the serial
    rounds, hops a tree and bytes a hop, the D2H / gloo / H2D seconds,
    each rank's peak allocation (torch's and the memory ledger's).
    Returns the ranks' launches summed, by kernel."""
    import shutil
    import tempfile
    import torch
    import lightgbm_tpu_torch as lt
    t_phase = time.perf_counter()
    cuda = device is None
    report = {"phase": "train_dist", "world": DIST_WORLD,
              "compute_mode": _compute_mode() if cuda else None}
    _check(not cuda or report["compute_mode"] == "Default",
           f"train_dist: compute mode {report['compute_mode']!r}: two "
           "processes share the GPU only in Default mode")
    tmp = tempfile.mkdtemp(prefix="train_dist_", dir=ROOT)
    procs = []
    try:
        t0 = time.perf_counter()
        path = os.path.join(tmp, "train.bin")
        data.dataset.save_binary(path)
        report["save_binary_s"] = time.perf_counter() - t0
        sync = torch.cuda.synchronize if cuda else (lambda: None)
        serial = {}
        for key, (params, rounds) in DIST_SERIAL.items():
            params = dict(params)
            if not cuda:
                params["device_type"] = device
            bst, ms = _rounds_ms(params, data.dataset, rounds, sync)
            serial[key] = {"text": _without_params(bst.model_to_string()),
                           "round_ms": ms.tolist(),
                           "auc": _auc(bst.predict(data.X_hold),
                                       data.y_hold)}
            del bst
        job = os.path.join(tmp, "job.json")
        with open(job, "w") as f:
            json.dump({"data": path, "out": tmp, "device": device,
                       "timeout_ms": DIST_TIMEOUT_S * 1000.0 / 3}, f)
        t0 = time.perf_counter()
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w")
                for r in range(DIST_WORLD)]
        store = os.path.join(tmp, "store")
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dist-worker",
             str(r), str(DIST_WORLD), store, job], stdout=logs[r],
            stderr=subprocess.STDOUT, cwd=ROOT) for r in range(DIST_WORLD)]
        deadline = time.monotonic() + DIST_TIMEOUT_S
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                break
        for lf in logs:
            lf.close()
        report["ranks_s"] = time.perf_counter() - t0
        rcs = [p.poll() for p in procs]
        if rcs != [0] * DIST_WORLD:
            tails = []
            for r in range(DIST_WORLD):
                with open(os.path.join(tmp, f"rank{r}.log")) as f:
                    tails.append(f"rank {r}: " + f.read()[-2000:])
            raise Failure(f"train_dist: ranks exited {rcs}\n"
                          + "\n".join(tails))
        reps = []
        for r in range(DIST_WORLD):
            with open(os.path.join(tmp, f"report.r{r}.json")) as f:
                reps.append(json.load(f))
        launches = {}
        runs = {}
        for name, learner, skey, gate in DIST_RUNS:
            texts = []
            for r in range(DIST_WORLD):
                with open(os.path.join(tmp, f"{name}.r{r}.txt")) as f:
                    texts.append(f.read())
            _check(all(t == texts[0] for t in texts),
                   f"train_dist: {name}: the ranks' models differ")
            ser = serial[skey]
            run = {"learner": learner, "serial": skey, "gate": gate}
            if gate == "bitwise":
                _check(_without_params(texts[0]) == ser["text"],
                       f"train_dist: {name}'s model differs from the "
                       f"serial card model ({skey})")
                run["model_text_identical"] = True
            else:
                auc = _auc(lt.Booster(model_str=texts[0]).predict(
                    data.X_hold), data.y_hold)
                run["auc"], run["serial_auc"] = auc, ser["auc"]
                _check(abs(auc - ser["auc"]) <= DIST_AUC_TOL,
                       f"train_dist: {name}: AUC {auc} vs serial "
                       f"{ser['auc']}")
            per_rank = []
            for rep in reps:
                rr = rep["runs"][name]
                st = rr["collectives"]
                hops = st.get("ring_fold", {"calls": 0, "bytes": 0})
                carry = rr["launches"]["histogram_carry_q"
                                       if skey == "quant_wave"
                                       else "histogram_carry"]
                if learner == "data" and cuda:
                    _check(carry > 0, f"train_dist: {name}: rank "
                           f"{rep['rank']} launched no carry kernel")
                per_hop = hops["bytes"] / hops["calls"] if hops["calls"] \
                    else 0
                _check(not (learner == "data" and cuda
                            and skey != "quant_wave")
                       or per_hop <= DIST_HOP_BYTES,
                       f"train_dist: {name}: {per_hop} B a hop of the f32 "
                       f"carry, over {DIST_HOP_BYTES}")
                per_rank.append({
                    "round_ms": rr["round_ms"], "launches": rr["launches"],
                    "hops_per_tree": hops["calls"] / rr["trees"],
                    "bytes_per_hop": per_hop,
                    "stages": _stage_totals(st), "collectives": st,
                    "wall_s": rr["wall_s"],
                    "peak_allocated": rr["peak_allocated"],
                    "ledger_peak_bytes": rr["ledger_peak_bytes"]})
                for k, v in rr["launches"].items():
                    launches[k] = launches.get(k, 0) + v
            run["serial_round_ms"] = ser["round_ms"]
            run["ranks"] = per_rank
            runs[name] = run
        report["runs"] = runs
        report["load_s"] = [rep["load_s"] for rep in reps]
        report["launches"] = launches
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    report["phase_s"] = time.perf_counter() - t_phase
    _emit(report)
    return launches


# ---------------------------------------------------------- serve_sharded
#: request sizes of the sharded serving phase, and the ragged tails
SHARD_ROWS = (1, 256, 4096)
SHARD_RAGGED = (257, 1000, 4097, 9001)


def phase_serve_sharded(seed, device=None, timing=True):
    """The sharded serving runtime (ROADMAP Queue 1 item 5f) on the card:
    main's 500-tree model on two replicas of the one GPU
    (`devices=[cuda:0, cuda:0]`), its answers bitwise the one-device
    runtime's at 1, 256 and 4096 rows and on ragged tails, raw and
    converted; `ModelRegistry(serve_shard_devices=2)` raises "exceeds
    visible devices" at load where fewer GPUs are visible.  Reports p50
    at each size, sharded and one-device, in turns; the routed rows.
    Returns the fused serving kernel's launches of the sharded runs."""
    import torch
    from lightgbm_tpu_torch import Booster, ServingRuntime, LightGBMError
    from lightgbm_tpu_torch.compiler import kernel
    from lightgbm_tpu_torch.serving import (ModelRegistry,
                                            ShardedServingRuntime)
    t_phase = time.perf_counter()
    dev = torch.device(device or "cuda", 0)
    bst = Booster(model_str=synthetic_forest_text(seed))
    rng = np.random.RandomState(seed + 7)
    reqs = {n: request_rows(rng, n) for n in SHARD_ROWS + SHARD_RAGGED}
    one = ServingRuntime(bst, device=dev)
    kernel.SERVE_LAUNCHES = 0
    sh = ShardedServingRuntime(bst, devices=[dev, dev], name="sharded")
    answers = {n: (sh.predict(X, raw_score=True), sh.predict(X))
               for n, X in reqs.items()}
    launches = kernel.SERVE_LAUNCHES
    _check(launches > 0, "serve_sharded: no fused serving launch")
    for n, X in reqs.items():
        _check(_bits_equal(answers[n][0], one.predict(X, raw_score=True))
               and _bits_equal(answers[n][1], one.predict(X)),
               f"serve_sharded: {n} rows differ from the one-device "
               "runtime")
    p50 = {}
    if timing:
        for n in SHARD_ROWS:
            tt = {"sharded": [], "one": []}
            for _ in range(30):
                for key, rt in (("sharded", sh), ("one", one)):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    rt.predict(reqs[n])
                    torch.cuda.synchronize()
                    tt[key].append(time.perf_counter() - t)
            p50[str(n)] = {k: float(np.median(v)) * 1e3
                           for k, v in tt.items()}
    report = {"phase": "serve_sharded", "replicas": sh.num_replicas,
              "devices": [str(d) for d in sh.devices],
              "bitwise_one_device": sorted(reqs), "p50_ms": p50,
              "routed_rows": sh.routed_rows(),
              "device_bytes": sh.device_bytes(),
              "one_device_bytes": one.device_bytes(), "launches": launches}
    visible = torch.cuda.device_count()
    reg = ModelRegistry({"serve_shard_devices": 2, "serve_warmup": False})
    try:
        if visible < 2:
            try:
                reg.load("m", bst)
                raised = ""
            except LightGBMError as e:
                raised = str(e)
            _check("exceeds visible devices" in raised,
                   f"serve_sharded: serve_shard_devices=2 on {visible} "
                   f"GPU(s) did not raise at load: {raised!r}")
            report["overflow_raised"] = raised
        else:
            entry = reg.load("m", bst)
            _check(_bits_equal(reg.predict(reqs[256], model="m"),
                               one.predict(reqs[256])),
                   "serve_sharded: the registry's sharded runtime differs")
            report["registry_replicas"] = entry.runtime.num_replicas
    finally:
        reg.close()
    report["phase_s"] = time.perf_counter() - t_phase
    _emit(report)
    return launches


# ------------------------------------------------------- predict_api
#: `device_predict`'s request sizes (100,000 rows: two chunks of 65,536)
PREDICT_ROWS = (1, 256, 4096, 10_000, 100_000)
#: the fused route is held bitwise its plain versions and the unfused
#: program at these sizes on every model, and timed at them on the main
#: model (65,536 rows: a full chunk)
FUSED_F32_ROWS = (1, 256, 4096, 65_536)
#: the f32 instance's launch plans are held bitwise the default plan at
#: these sizes and timed at a full chunk only (at 4096 rows the default
#: was within 1.3% of the best on an H100): single blocks and pairs of
#: blocks, rows in shared memory, 1 or 2 cursors, and 256-row blocks
#: with staged records (the rest of FUSED_SWEEP, clusters of 4 and 8 and
#: staging at fewer rows, ran 1.3x to 13x slower at 65,536 rows: PERF.md)
FUSED_F32_SWEEP_ROWS = (4096, 65_536)
FUSED_F32_TIMED_SWEEP_ROWS = 65_536
FUSED_F32_SWEEP = tuple((c, r, i, 512, False) for c in (1, 2)
                        for r in (1, 4, 16, 64, 256) for i in (1, 2)) + tuple(
    (1, 256, i, 512, True) for i in (1, 2))
#: up to here the port's CPU result is computed too (the CPU's plain
#: traversal of 500 trees is slow beyond), and the f64 host walk
PREDICT_CPU_ROWS = 10_000
#: the host-side options are timed on this many rows of the binary
#: golden model
PREDICT_HOST_ROWS = 20
#: timed `device_predict` requests a size (the median is reported)
PREDICT_REPEATS = 7


class _plain_kernels:
    """Within it, `device_predict` runs its plain versions on the card:
    the fused kernel's f32 instance, the standalone traverse, the f32 sum
    and the link's wrappers are swapped for their plain versions (which
    count no launch), so the program's staging, chunks and padding stay
    the booster's own."""

    def __enter__(self):
        from lightgbm_tpu_torch.compiler import kernel
        from lightgbm_tpu_torch.ops import predict, xla_math
        self.saved = [(kernel, "serve_forest_f32", kernel.serve_forest_f32),
                      (kernel, "traverse_bucket", kernel.traverse_bucket),
                      (predict, "accumulate_slots_f32",
                       predict.accumulate_slots_f32),
                      (xla_math, "_link", xla_math._link)]
        kernel.serve_forest_f32 = (
            lambda *a, plan=None: kernel.serve_forest_f32_plain(*a))
        kernel.traverse_bucket = (
            lambda *a, plan=None: kernel.traverse_bucket_plain(*a))
        predict.accumulate_slots_f32 = predict.accumulate_slots_f32_plain
        xla_math._link = lambda x, sigmoid: (
            xla_math.xla_sigmoid_plain(x) if sigmoid
            else xla_math.xla_exp_f32_plain(x))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False


def _predict_counters():
    from lightgbm_tpu_torch.compiler import kernel
    from lightgbm_tpu_torch.ops import predict, xla_math
    return {"serve": kernel.SERVE_LAUNCHES,
            "serve_f32": kernel.SERVE_F32_LAUNCHES,
            "traverse": kernel.TRAVERSE_LAUNCHES,
            "accumulate_f32": predict.ACCUMULATE_F32_LAUNCHES,
            "accumulate": predict.ACCUMULATE_LAUNCHES,
            "stacked": predict.STACKED_LAUNCHES,
            "xla_link": xla_math.LINK_LAUNCHES}


def _zero_predict_counters():
    from lightgbm_tpu_torch.compiler import kernel
    from lightgbm_tpu_torch.ops import predict, xla_math
    kernel.SERVE_LAUNCHES = 0
    kernel.SERVE_F32_LAUNCHES = 0
    kernel.TRAVERSE_LAUNCHES = 0
    predict.ACCUMULATE_F32_LAUNCHES = 0
    predict.ACCUMULATE_LAUNCHES = 0
    predict.STACKED_LAUNCHES = 0
    xla_math.LINK_LAUNCHES = 0


def unfused_program(bst, device):
    """`bst`'s `device_predict` program within the plan as it ran before
    the fused route (the JAX package's program): a function of staged
    rows X [B, F] f32 on `device` that runs each depth bucket's
    standalone traverse (X padded to a multiple of ROW_BLOCK rows), then
    the standalone f32 sum of their slots, tree t's at its plan row:
    [B] or [B, K] float32.  The plan is `Booster._device_predict_state`'s
    (averaging off); the function carries its `planes`, `meta` and
    `gidx`."""
    import torch
    from lightgbm_tpu_torch.compiler import build_plan, kernel
    from lightgbm_tpu_torch.ops import predict
    from lightgbm_tpu_torch.serving.runtime import DEFAULT_TILE_KB
    st = bst._device_predict_state(0, None, device)
    plan = build_plan(dict(bst.export_predict_arrays(0, -1, device=device),
                           average_factor=1), tile_vmem_kb=DEFAULT_TILE_KB)
    planes, meta = kernel.device_planes(plan, device)
    gidx = torch.from_numpy(plan.gather_idx).to(device)

    def run(X):
        b = X.shape[0]
        if b > kernel.ROW_BLOCK and b % kernel.ROW_BLOCK:
            X = torch.cat([X, X.new_zeros(-b % kernel.ROW_BLOCK,
                                          X.shape[1])])
        return predict.accumulate_slots_f32(
            kernel.traverse_all(X, planes, meta), gidx, st.values,
            n_class=st.num_class, cls=st.cls)[:b]

    run.planes, run.meta, run.gidx = planes, meta, gidx
    return run


class _unfused_route:
    """Within it, `device_predict` runs the unfused program
    (`unfused_program`) where it would launch the fused kernel's f32
    instance, on the booster's own staging and chunks."""

    def __init__(self, prog):
        self.prog = prog

    def __enter__(self):
        from lightgbm_tpu_torch.compiler import kernel
        self.saved = kernel.serve_forest_f32
        kernel.serve_forest_f32 = (
            lambda X, rec, values, n_class=1, plan=None: self.prog(X))
        return self

    def __exit__(self, *exc):
        from lightgbm_tpu_torch.compiler import kernel
        kernel.serve_forest_f32 = self.saved
        return False


def _fused_gates(name, bst, prog, X, rows, device_type="cuda"):
    """`bst.predict(X[:n], device_predict=True)` at each of `rows`, raw
    and converted, through the fused route: bitwise the same program with
    its plain versions on the card (`_plain_kernels`) and bitwise the
    unfused program `prog` (`_unfused_route`), in this call."""
    import torch
    _check(bst._device_predict_state(0, None, torch.device(device_type))
           .records is not None, f"predict_api: {name} has no records")
    for n in rows:
        for raw in (True, False):
            kw = {"raw_score": raw, "device_predict": True,
                  "device_type": device_type}
            got = bst.predict(X[:n], **kw)
            with _plain_kernels():
                plain = bst.predict(X[:n], **kw)
            with _unfused_route(prog):
                unfused = bst.predict(X[:n], **kw)
            what = "raw" if raw else "converted"
            _check(_bits_equal(got, plain),
                   f"predict_api: {name}, {n} rows, {what}: the fused "
                   f"route != its plain versions on the card")
            _check(_bits_equal(got, unfused),
                   f"predict_api: {name}, {n} rows, {what}: the fused "
                   f"route != the unfused program on the card")
    return {"rows": list(rows), "bitwise_plain_card": True,
            "bitwise_unfused_card": True}


def _rf_text(text):
    """A model text as a random forest's: its header with
    `average_output`, so every output is the mean over its iterations
    (the reference's `boosting=rf` texts carry that line)."""
    head, sep, rest = text.partition("\nfeature_names=")
    return head + "\naverage_output" + sep + rest


def _device_predicts(name, bst, cpu_bst, X, device_type, cpu_rows,
                     host=None, prog=None):
    """`bst.predict(X, device_predict=True)` raw and converted, counted,
    then held against the same program with every plain version on the
    card (`_plain_kernels`) and, up to `cpu_rows` rows, against
    `cpu_bst`'s on the CPU, bitwise.  With `host` (the f64 walk's raw
    scores and leaves of X[:len(host[0])]) and `prog` (the booster's
    `unfused_program`, whose planes route the leaves), the rows whose
    leaves differ from the walk's and the f32 sums' largest difference
    from it.
    Returns (raw, launches, report)."""
    import torch
    n = X.shape[0]
    kw = {"device_predict": True, "device_type": device_type}
    c0 = _predict_counters()
    raw = bst.predict(X, raw_score=True, **kw)
    c1 = _predict_counters()
    conv = bst.predict(X, **kw)
    c2 = _predict_counters()
    raw_l = {k: c1[k] - c0[k] for k in c0}
    conv_l = {k: c2[k] - c1[k] for k in c0}
    with _plain_kernels():
        p_raw = bst.predict(X, raw_score=True, **kw)
        p_conv = bst.predict(X, **kw)
    _check(_predict_counters() == c2,
           f"predict_api: {name}: a plain version counted a launch")
    _check(_bits_equal(raw, p_raw) and _bits_equal(conv, p_conv),
           f"predict_api: {name}, {n} rows: device_predict != its plain "
           f"versions on the card")
    _check(raw.dtype == np.float64 and np.all(np.isfinite(raw))
           and raw.shape[0] == n and np.all(np.isfinite(conv)),
           f"predict_api: {name}, {n} rows: outputs not finite")
    rep = {"rows": n, "bitwise_plain_card": True, "raw_launches": raw_l,
           "converted_launches": conv_l}
    if n <= cpu_rows:
        ckw = dict(kw, device_type="cpu")
        _check(_bits_equal(raw, cpu_bst.predict(X, raw_score=True, **ckw))
               and _bits_equal(conv, cpu_bst.predict(X, **ckw)),
               f"predict_api: {name}, {n} rows: the card != the CPU")
        rep["bitwise_cpu"] = True
    if host is not None:
        h_raw, h_leaf = host
        m = min(n, len(h_raw))
        dev = torch.device(device_type)
        K = bst._device_predict_state(0, None, dev).num_class
        leaves = [_device_leaves(prog, X[lo:min(lo + 4096, m)], dev)
                  for lo in range(0, m, 4096)]
        leaves = np.concatenate(leaves) if leaves else h_leaf[:0]
        rep["rows_routed_otherwise"] = int(
            (leaves != h_leaf[:m]).any(axis=1).sum())
        rep["max_abs_diff_vs_f64_walk"] = _max_abs_err(
            raw[:m].reshape(m, K), h_raw[:m].reshape(m, K))
    return raw, {"raw": raw_l, "converted": conv_l}, rep


def _device_leaves(prog, Xc, dev):
    """The leaves of the rows Xc (at most one chunk), [rows, T] in
    boosting order, by the standalone K6's plain version over the planes
    of `prog` (an `unfused_program`; bitwise the kernel's slots in the
    golden and main phases), so that no launch is counted."""
    from lightgbm_tpu_torch.booster import stage_rows
    from lightgbm_tpu_torch.compiler import kernel
    with _plain_kernels():
        slots = kernel.traverse_all(stage_rows(Xc, dev), prog.planes,
                                    prog.meta)
    return slots[prog.gidx.long()][:, :len(Xc)].t().cpu().numpy()


def _host_walk(bst, X):
    """The f64 host walk's raw scores and [rows, T] leaves of X."""
    return bst.predict(X, raw_score=True), bst.predict(X, pred_leaf=True)


def phase_predict_api(seed, device_type="cuda", rows=PREDICT_ROWS,
                      cpu_rows=PREDICT_CPU_ROWS, timing=True,
                      num_trees=500, fused_rows=FUSED_F32_ROWS,
                      sweep_rows=FUSED_F32_SWEEP_ROWS):
    """`Booster.predict`'s options on the main phase's model (500 trees x
    255 leaves x 28 features, from `seed`): `device_predict` (within the
    plan one launch of the fused kernel's f32 instance a chunk of 65,536
    rows, the link a converted chunk) at each of `rows`, raw and
    converted, bitwise its plain versions on the card and, up to
    `cpu_rows`, the port's CPU result; the rows routed otherwise than the
    f64 host walk and the f32 sums' largest difference from it; the five
    golden models and a random-forest text the same way; the launches
    of the phase (the f64 fused kernel, the standalone traverse and the
    standalone sums 0).  Then, out of the counted path, at each of
    `fused_rows` on every model, raw and converted, the fused route
    bitwise its plain versions and the unfused program (each bucket's
    traverse, then the f32 sum); the stacked route (a model past the
    plan's feature field) counted and bitwise the fused route; the fused
    launch timed warm and L2-flushed in turns with the unfused program
    beside its bound, a sweep of its launch plans at `sweep_rows`; the
    standalone f32 sum (the stacked route's) at 4096 rows beside its
    bound, its plain version and the f64 standalone sum; the host
    seconds of `pred_leaf`, prediction early stop and `pred_contrib` on
    20 rows of the binary golden model.  Returns the kernels-line
    entries of the fused f32 launch and the f32 sum, and the phase's
    launches."""
    import torch
    from lightgbm_tpu_torch import Booster
    from lightgbm_tpu_torch.booster import DEVICE_PREDICT_CHUNK, stage_rows
    from lightgbm_tpu_torch.compiler import kernel
    from lightgbm_tpu_torch.compiler.records import (MAX_ROW_BLOCKS,
                                                     forest_plan)
    from lightgbm_tpu_torch.ops.predict import (
        accumulate_slots_exact, accumulate_slots_f32,
        accumulate_slots_f32_plain)
    t_phase = time.perf_counter()
    dev = torch.device(device_type)
    text = synthetic_forest_text(seed, num_trees=num_trees)
    bst, cpu_bst = Booster(model_str=text), Booster(model_str=text)
    X_all = request_rows(np.random.RandomState(seed + 2),
                         max(max(rows), max(fused_rows)))
    _zero_predict_counters()
    t0 = time.perf_counter()
    st = bst._device_predict_state(0, None, dev)
    setup_s = time.perf_counter() - t0
    _check(st.records is not None, "predict_api: the plan has no records")
    prog = unfused_program(bst, dev)
    buckets = len(prog.planes)
    host = _host_walk(bst, X_all[:min(cpu_rows, max(rows))])
    report = {"phase": "predict_api", "trees": num_trees,
              "buckets": buckets, "setup_s": setup_s,
              "record_bytes": st.records.nbytes(), "sizes": {}}
    for n in rows:
        t0 = time.perf_counter()
        _, launches, rep = _device_predicts(
            f"main {n}", bst, cpu_bst, X_all[:n], device_type, cpu_rows,
            host=host if n <= cpu_rows else None, prog=prog)
        chunks = -(-n // DEVICE_PREDICT_CHUNK)
        want = {"serve": 0, "serve_f32": chunks, "traverse": 0,
                "accumulate_f32": 0, "accumulate": 0, "stacked": 0,
                "xla_link": 0}
        _check(launches["raw"] == want
               and launches["converted"] == dict(want, xla_link=chunks),
               f"predict_api: {n} rows: launches {launches}, want {want} "
               f"(and the link once a converted chunk)")
        if n <= cpu_rows:
            _check(rep["rows_routed_otherwise"] == 0,
                   f"predict_api: {n} rows: rows routed otherwise than the "
                   f"f64 walk on f32-exact rows and thresholds")
        rep["chunks"] = chunks
        rep["s"] = time.perf_counter() - t0
        report["sizes"][str(n)] = rep
    main_launches = _predict_counters()

    # ---- the golden models and a random forest, the same way
    models = [(name, open(os.path.join(
        ROOT, "tests", "data", f"golden_{name}.model.txt")).read())
        for name in GOLDEN]
    models.append(("rf_binary", _rf_text(models[0][1])))
    report["golden"] = {}
    golden = {}
    for name, mtext in models:
        g, g_cpu = Booster(model_str=mtext), Booster(model_str=mtext)
        _check(g._average_output == (name == "rf_binary"),
               f"predict_api: {name}: average_output read wrong")
        nf = g.num_feature()
        rng = np.random.RandomState(seed + 3)
        X = np.vstack([adversarial_rows(g.trees, nf, seed),
                       rng.randn(256, nf)])
        g_prog = unfused_program(g, dev)
        _, launches, rep = _device_predicts(name, g, g_cpu, X, device_type,
                                            cpu_rows, host=_host_walk(g, X),
                                            prog=g_prog)
        _check(launches["raw"]["serve_f32"] == 1
               and launches["raw"]["traverse"] == 0
               and launches["raw"]["accumulate_f32"] == 0,
               f"predict_api: {name}: launches {launches}")
        if name == "rf_binary":
            rep["average_factor"] = int(g._device_predict_state(
                0, None, dev).average_factor)
            _check(rep["average_factor"] == g.num_trees(),
                   "predict_api: the forest is not averaged")
        report["golden"][name] = rep
        golden[name] = (g, nf, g_prog)
    phase_launches = _predict_counters()
    _check(phase_launches["serve"] == 0 and phase_launches["accumulate"] == 0,
           f"predict_api: the fused kernel or the f64 sum ran: "
           f"{phase_launches}")
    _check(phase_launches["serve_f32"] > 0
           and phase_launches["traverse"] == 0
           and phase_launches["accumulate_f32"] == 0
           and phase_launches["stacked"] == 0,
           f"predict_api: the plan route left the fused kernel: "
           f"{phase_launches}")

    # ---- a raw request's wall time by size, synchronised (after the
    # phase's launches were read)
    for n in rows if timing else ():
        times = []
        for _ in range(PREDICT_REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bst.predict(X_all[:n], raw_score=True, device_predict=True)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        report["sizes"][str(n)]["p50_ms"] = float(np.median(times)) * 1e3

    # ---- the fused route bitwise its plain versions and the unfused
    # program at `fused_rows`, on every model (after the counters' read)
    t0 = time.perf_counter()
    report["fused_gates"] = {"main": _fused_gates(
        "main", bst, prog, X_all, fused_rows, device_type)}
    for name, (g, nf, g_prog) in golden.items():
        rng = np.random.RandomState(seed + 5)
        adv = adversarial_rows(g.trees, nf, seed)
        X = np.vstack([adv, rng.randn(max(max(fused_rows) - len(adv), 0),
                                      nf)])
        report["fused_gates"][name] = _fused_gates(name, g, g_prog, X,
                                                   fused_rows, device_type)
    report["fused_gates_s"] = time.perf_counter() - t0

    # ---- the stacked route: the main model with feature 27 renamed
    # 4096, past the plan's 12-bit field, one stacked traversal and one
    # f32 sum a chunk, bitwise the fused route on the same rows
    nf = X_all.shape[1]
    q_bst = Booster(model_str=_widen_text(text, 4097,
                                          feature_map={nf - 1: 4096}))
    q_rows = min(4096, len(X_all))
    Xq = np.zeros((q_rows, 4097))
    Xq[:, :nf - 1] = X_all[:q_rows, :nf - 1]
    Xq[:, 4096] = X_all[:q_rows, nf - 1]
    _check(q_bst._device_predict_state(0, None, dev).records is None,
           "predict_api: the (q) model has records")
    c0 = _predict_counters()
    q_raw = q_bst.predict(Xq, raw_score=True, device_predict=True,
                          device_type=device_type)
    c1 = _predict_counters()
    stacked_launches = {k: c1[k] - c0[k] for k in c0}
    _check(stacked_launches == {"serve": 0, "serve_f32": 0, "traverse": 0,
                                "accumulate_f32": 1, "accumulate": 0,
                                "stacked": 1, "xla_link": 0},
           f"predict_api: the stacked route's launches {stacked_launches}")
    _check(_bits_equal(q_raw, bst.predict(
        X_all[:q_rows], raw_score=True, device_predict=True,
        device_type=device_type)),
           "predict_api: the stacked route != the fused route")
    report["stacked_route"] = {"rows": q_rows, "launches": stacked_launches,
                               "bitwise_fused_route": True}

    # ---- the fused f32 launch at `fused_rows`: parity, bound, times in
    # turns with the unfused program (each bucket's traverse, the f32
    # sum), and a sweep of its launch plans
    ex = bst.export_predict_arrays(0, -1, device=dev)
    n_trees, nl = st.values.shape
    rec = st.records
    flush = _flusher(dev) if timing else None
    fused_by_rows = {}
    fused_err = 0.0
    for n in fused_rows:
        Xd = stage_rows(X_all[:n], dev, pad=False)
        b, f = Xd.shape

        def fused(Xd=Xd):
            return kernel.serve_forest_f32(Xd, rec, st.values)

        def unfused(Xd=Xd):
            return prog(Xd)

        got = fused().cpu().numpy()
        _check(_bits_equal(got, unfused().cpu().numpy()),
               f"predict_api: {n} rows: the fused f32 launch != the "
               f"unfused program")
        if n <= 4096:
            plain = kernel.serve_forest_f32_plain(Xd, rec, st.values)
            fused_err = max(fused_err, _max_abs_err(got,
                                                    plain.cpu().numpy()))
            _check(_bits_equal(got, plain.cpu().numpy()),
                   f"predict_api: {n} rows: the fused f32 launch != its "
                   f"plain version")
        # the bound: the sectors the walks read
        nbytes, visits = _serve_bytes(Xd, rec, st.values)
        slots = kernel.traverse_all(stage_rows(X_all[:n], dev), prog.planes,
                                    prog.meta)[prog.gidx.long()][:, :b]
        _check(visits == _record_visits(ex, slots),
               f"predict_api: {n} rows: the records' walk visits {visits} "
               f"nodes, the slots' depths {_record_visits(ex, slots)}")
        bound_ms, bound_by = _bound(nbytes, visits, INT32_OPS_PER_S)
        plan = forest_plan(b, f, n_trees, rec.ni_max, rec.mw, 1,
                           value_bytes=4)
        row = {"rows": n, "staged_rows": b, "plan": plan._asdict(),
               "bytes": nbytes, "node_visits": visits,
               "bound_ms": bound_ms, "bound_by": bound_by}
        if timing:
            turns = _turns(fused, unfused, timing, flush)
            for key in ("ms", "device_ms", "cold_device_ms"):
                row["fused_" + key] = turns[key]
                row["unfused_" + key] = turns["baseline_" + key]
            if n == 4096:       # the kernels line's size
                row["plain_ms"] = _cuda_ms(
                    lambda: kernel.serve_forest_f32_plain(Xd, rec,
                                                          st.values),
                    iters=3, warmup=1)
        fused_by_rows[str(n)] = row
    del flush
    report["fused_f32"] = fused_by_rows
    # the f32 instance's launch plans at `sweep_rows`, each bitwise the
    # default plan first
    sweeps = {}
    for n in sweep_rows:
        Xd = stage_rows(X_all[:n], dev, pad=False)
        b, f = Xd.shape
        default = forest_plan(b, f, n_trees, rec.ni_max, rec.mw, 1,
                              value_bytes=4)
        got = kernel.serve_forest_f32(Xd, rec, st.values).cpu().numpy()
        vplans = {}
        for c, r, i, nt, stg in FUSED_F32_SWEEP + (
                (1, default.rows, default.ilp, 512, False),):
            if r > b or -(-b // r) > MAX_ROW_BLOCKS:
                continue
            p = forest_plan(b, f, n_trees, rec.ni_max, rec.mw, 1,
                            cluster=c, rows=r, ilp=i, threads=nt,
                            stage=stg, value_bytes=4)
            key = (f"c{p.cluster}_r{p.rows}_i{p.ilp}_t{p.threads}"
                   f"{'_staged' if p.stage else ''}")
            if key not in vplans:
                vplans[key] = p
                _check(_bits_equal(kernel.serve_forest_f32(
                    Xd, rec, st.values, plan=p).cpu().numpy(), got),
                       f"predict_api: {n} rows: fused f32 plan {key} != "
                       f"the default plan")
        sw = {"rows": n, "default": default._asdict()}
        if timing and n == FUSED_F32_TIMED_SWEEP_ROWS:
            vt = {k: _cuda_ms(lambda p=p: kernel.serve_forest_f32(
                Xd, rec, st.values, plan=p), queued=True)
                for k, p in vplans.items()}
            sw["variants_ms"] = dict(sorted(vt.items(), key=lambda kv: kv[1]))
        else:
            sw["variants"] = sorted(vplans)
        sweeps[str(n)] = sw
    report["fused_f32_sweeps"] = sweeps
    big_rows = 4096 if 4096 in fused_rows else max(fused_rows)
    big = fused_by_rows[str(big_rows)]

    def by_rows(key):
        return {k: v.get(key) for k, v in fused_by_rows.items()}

    fused_entry = {
        "name": "serve_forest_f32", "route": "cuda",
        "source": "lightgbm_tpu_torch/csrc/serve.cu",
        "replaces": "lightgbm_tpu/ops/predict.py:188, "
                    "lightgbm_tpu/compiler/kernel.py:155",
        "launches": phase_launches["serve_f32"], "max_abs_err": fused_err,
        "ms": big.get("fused_device_ms", 0.0),
        "plain_ms": big.get("plain_ms", 0.0),
        "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
        "library_ms": None, "library_note": "no torch call walks a forest",
        "rows": big_rows, "ms_by_rows": by_rows("fused_device_ms"),
        "cold_ms_by_rows": by_rows("fused_cold_device_ms"),
        "unfused_ms_by_rows": by_rows("unfused_device_ms"),
        "unfused_cold_ms_by_rows": by_rows("unfused_cold_device_ms"),
        "bound_ms_by_rows": by_rows("bound_ms")}

    # ---- the standalone f32 sum (the stacked route's) at 4096 rows:
    # parity, times, bound
    Xd = stage_rows(X_all[:4096], dev)
    slots, gidx = kernel.traverse_all(Xd, prog.planes, prog.meta), prog.gidx
    f32 = accumulate_slots_f32(slots, gidx, st.values)
    f32_p = accumulate_slots_f32_plain(slots, gidx, st.values)
    err = _max_abs_err(f32.cpu().numpy(), f32_p.cpu().numpy())
    _check(err == 0.0 and _bits_equal(f32.cpu().numpy(),
                                      f32_p.cpu().numpy()),
           "predict_api: the f32 sum != its plain version at 4096 rows")
    nbytes = (n_trees * 4096 * 4 + n_trees * 4 + n_trees * nl * 4
              + 4096 * 4)
    bound_ms, bound_by = _bound(nbytes, n_trees * 4096,
                                DISPATCH_LANES_PER_S)
    entry = {"name": "accumulate_f32", "route": "cuda",
             "source": "lightgbm_tpu_torch/csrc/accumulate.cu",
             "replaces": "lightgbm_tpu/ops/predict.py:188",
             "serves": "device_predict's stacked route",
             "launches": stacked_launches["accumulate_f32"],
             "max_abs_err": err, "ms": None, "plain_ms": None,
             "bound_ms": bound_ms, "bound_by": bound_by,
             "bound_bytes": nbytes, "library_ms": None,
             "library_note": "no single torch call sums in boosting order",
             "rows": 4096}
    if timing:
        entry["ms"] = _cuda_ms(lambda: accumulate_slots_f32(
            slots, gidx, st.values), queued=True)
        entry["f64_sum_ms"] = _cuda_ms(lambda: accumulate_slots_exact(
            slots, gidx, ex["value_f64"]), queued=True)
        entry["plain_ms"] = _cuda_ms(lambda: accumulate_slots_f32_plain(
            slots, gidx, st.values), iters=3, warmup=1)
        entry["cold_ms"] = _cuda_ms(lambda: accumulate_slots_f32(
            slots, gidx, st.values), queued=True,
            flush=_flusher(dev))
    else:
        entry["ms"] = entry["plain_ms"] = entry["f64_sum_ms"] = 0.0

    # ---- the host-side options on 20 rows of the binary golden model
    g = Booster(model_file=os.path.join(ROOT, "tests", "data",
                                        "golden_binary.model.txt"))
    Xh = np.random.RandomState(seed + 4).randn(PREDICT_HOST_ROWS,
                                               g.num_feature())
    host_s = {}
    for label, kw in (("pred_leaf", {"pred_leaf": True}),
                      ("early_stop", {"pred_early_stop": True,
                                      "pred_early_stop_freq": 1,
                                      "pred_early_stop_margin": 0.5}),
                      ("pred_contrib", {"pred_contrib": True})):
        t0 = time.perf_counter()
        out = g.predict(Xh, **kw)
        host_s[label] = time.perf_counter() - t0
        _check(np.all(np.isfinite(out)), f"predict_api: {label} not finite")
    contrib = g.predict(Xh, pred_contrib=True)
    _check(np.allclose(contrib.sum(axis=1), g.predict(Xh, raw_score=True),
                       rtol=0, atol=1e-6),
           "predict_api: pred_contrib rows do not sum to the raw scores")
    report.update({"launches_main_model": main_launches,
                   "launches": phase_launches, "host_s": host_s,
                   "f32_sum_4096": entry,
                   "phase_s": time.perf_counter() - t_phase})
    _emit(report)
    return [fused_entry, entry], phase_launches


# ------------------------------------------------------------ serve_plane
#: the serve_plane phase's HTTP load: client threads x requests each, of
#: 1 to SERVE_HTTP_MAX_ROWS rows
SERVE_HTTP_THREADS = 8
SERVE_HTTP_REQUESTS = 200
SERVE_HTTP_MAX_ROWS = 256
#: timed requests a (rung, size) in serve_plane (the median is reported)
SERVE_REPEATS = 15
#: the interpreter's switch interval of serve_plane's third HTTP run
HTTP_SHORT_SWITCH_S = 2e-4


def _serve_counters():
    import lightgbm_tpu_torch.booster as booster
    from lightgbm_tpu_torch.compiler import kernel
    from lightgbm_tpu_torch.ops import predict, xla_math
    return {"serve": kernel.SERVE_LAUNCHES,
            "traverse": kernel.TRAVERSE_LAUNCHES,
            "accumulate": predict.ACCUMULATE_LAUNCHES,
            "accumulate_f32": predict.ACCUMULATE_F32_LAUNCHES,
            "stacked": predict.STACKED_LAUNCHES,
            "bounded": predict.ACCUMULATE_BOUNDED_LAUNCHES,
            "xla_link": xla_math.LINK_LAUNCHES,
            "device_predict_stacked": booster.DEVICE_PREDICT_STACKED}


def _zero_serve_counters():
    import lightgbm_tpu_torch.booster as booster
    from lightgbm_tpu_torch.compiler import kernel
    from lightgbm_tpu_torch.ops import predict, xla_math
    kernel.SERVE_LAUNCHES = kernel.TRAVERSE_LAUNCHES = 0
    predict.ACCUMULATE_LAUNCHES = predict.ACCUMULATE_F32_LAUNCHES = 0
    predict.STACKED_LAUNCHES = predict.ACCUMULATE_BOUNDED_LAUNCHES = 0
    xla_math.LINK_LAUNCHES = 0
    booster.DEVICE_PREDICT_STACKED = 0


def _counted(fn):
    """(fn(), the launches it made)."""
    before = _serve_counters()
    out = fn()
    after = _serve_counters()
    return out, {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}


def wide_bitset_text(text, words, seed=0):
    """A categorical model text with its first tree's categorical nodes
    given bitsets of `words[0]`, `words[1]`, ... random words (the
    categorical golden model has two such nodes in its first tree)."""
    rng = np.random.RandomState(seed)
    bits = [rng.randint(0, 1 << 32, size=w, dtype=np.uint64)
            for w in words]
    bounds = np.concatenate([[0], np.cumsum(words)])
    lines = text.splitlines()
    i = next(k for k, ln in enumerate(lines)
             if ln.startswith("cat_boundaries="))
    _check(lines[i + 1].startswith("cat_threshold="),
           "wide_bitset_text: no cat_threshold line")
    lines[i] = "cat_boundaries=" + " ".join(str(int(b)) for b in bounds)
    lines[i + 1] = "cat_threshold=" + " ".join(
        str(int(v)) for b in bits for v in b)
    return "\n".join(lines) + "\n"


def _widen_text(text, num_features, feature_map=None, extra_tree=None):
    """`text` over `num_features` columns: split features renamed by
    `feature_map` (old id -> new id), and `extra_tree` (a tree's text
    lines) appended; the header's feature lines and tree sizes follow."""
    head, _, rest = text.partition("\nTree=")
    body, _, footer = ("Tree=" + rest).partition("end of trees")
    trees = [t for t in body.split("\n\n\n") if t.strip()]
    if feature_map:
        out = []
        for t in trees:
            lines = t.splitlines()
            for k, ln in enumerate(lines):
                if ln.startswith("split_feature="):
                    lines[k] = "split_feature=" + " ".join(
                        str(feature_map.get(int(v), int(v)))
                        for v in ln.split("=", 1)[1].split())
            out.append("\n".join(lines))
        trees = out
    if extra_tree is not None:
        trees.append("\n".join([f"Tree={len(trees)}"] + extra_tree))
    trees = [t.strip("\n") + "\n\n" for t in trees]
    hl = head.splitlines()
    for k, ln in enumerate(hl):
        if ln.startswith("max_feature_idx="):
            hl[k] = f"max_feature_idx={num_features - 1}"
        elif ln.startswith("feature_names="):
            hl[k] = "feature_names=" + " ".join(
                f"Column_{i}" for i in range(num_features))
        elif ln.startswith("feature_infos="):
            hl[k] = "feature_infos=" + " ".join(["none"] * num_features)
        elif ln.startswith("tree_sizes="):
            hl[k] = "tree_sizes=" + " ".join(str(len(t) + 1) for t in trees)
    return "\n".join(hl) + "\n" + "\n".join(trees) + "end of trees" + footer


def guard_tree_text(text, num_features, guard_feature):
    """`text` plus one tree that splits on `guard_feature` only behind a
    root no row passes (feature 0 <= -1e30, missing type None): the model
    needs `guard_feature + 1` columns, and a request of `num_features`
    columns is narrower than it, yet walks on the host without reading
    the absent column."""
    tree = ["num_leaves=3", "num_cat=0",
            f"split_feature=0 {guard_feature}", "split_gain=1 1",
            "threshold=-1.0000000000000000e+30 0", "decision_type=0 0",
            "left_child=1 -1", "right_child=-3 -2",
            "leaf_value=0.25 -0.5 0.125", "leaf_weight=1 1 1",
            "leaf_count=1 1 1", "internal_value=0 0",
            "internal_weight=1 1", "internal_count=2 1", "is_linear=0",
            "shrinkage=1"]
    return _widen_text(text, guard_feature + 1, extra_tree=tree)


def _stacked_bytes(ex, stacked, slots, nf):
    """Bytes the stacked traversal must move for the rows of `slots`
    [T, B] (its output on them): the 32-byte sectors of the records its
    walks visit (every root, and each internal node on the path to a
    leaf some row reached), the bitset words whole, X once and the slots
    out."""
    t_trees, ni = stacked["feat"].shape
    s = slots.cpu().numpy()
    seen = np.zeros((t_trees, ni), bool)
    seen[:, 0] = True
    for i, t in enumerate(ex["trees"]):
        k = t.num_leaves - 1
        if k <= 0:
            continue
        up = np.full(k, -1, np.int64)          # a node's parent
        leaf_up = np.full(k + 1, -1, np.int64)  # a leaf's parent
        for nd in range(k):
            for c in (int(t.left_child[nd]), int(t.right_child[nd])):
                if c < 0:
                    leaf_up[~c] = nd
                else:
                    up[c] = nd
        for leaf in np.unique(s[i]):
            nd = leaf_up[leaf]
            while nd >= 0 and not seen[i, nd]:
                seen[i, nd] = True
                nd = up[nd]
    rec = stacked["rec"]
    per_sector = 32 // (4 * int(rec.shape[-1]))
    sectors = len(np.unique(np.flatnonzero(seen) // per_sector))
    words = stacked.get("cat_words")
    words = 0 if words is None else int(words.numel() * 4)
    return sectors * 32 + words + s.shape[1] * nf * 4 + s.size * 4


def _serve_bytes(X, rec, leaf_values, n_class=1, chunk=64):
    """(bytes, node visits) of the fused kernel's launch over the rows X
    [B, F] f32 (either instance, by `leaf_values`' dtype): X once, the
    trees' meta whole, the 32-byte sectors of the records, bitset words
    and leaf values that the walks read, and the output.  The walks are
    `compiler/kernel.py _serve_plain`'s over the records, run on X's
    device `chunk` trees at a time; a visit is a record read."""
    import torch
    from lightgbm_tpu_torch.compiler.kernel import _features, _route
    b, f = X.shape
    t_trees, nl = leaf_values.shape
    vb = leaf_values.element_size()
    dev = X.device
    mw = rec.mw
    w_all = rec.nodes[:, 0].contiguous()
    k_all = rec.nodes[:, 1].contiguous()
    thr_all = rec.nodes[:, 2].contiguous().view(torch.float32)
    meta = rec.meta.long()
    xt = X.t()
    seen = torch.zeros(rec.nodes.shape[0], dtype=torch.bool, device=dev)
    words = torch.zeros(rec.nodes.shape[0] * max(mw, 1), dtype=torch.bool,
                        device=dev)
    leaves = torch.zeros(t_trees * nl, dtype=torch.bool, device=dev)
    visits = 0
    for t0 in range(0, t_trees, chunk):
        m = meta[t0:t0 + chunk]
        for depth in torch.unique(m[:, 2]).tolist():
            sel = torch.nonzero(m[:, 2] == depth).flatten()
            first, ni = m[sel, :1], m[sel, 1:2]
            cur = torch.zeros((len(sel), b), dtype=torch.int64, device=dev)
            for _ in range(depth):
                live = cur >= 0
                in_range = live & (cur < ni)
                idx = first + torch.where(in_range, cur, 0)
                visits += int(live.sum())
                seen[idx[live]] = True
                w = w_all[idx]

                def cat_of(widx, idx=idx, read=live & (w < 0)):
                    words[(idx * mw + widx)[read]] = True
                    return rec.catw[idx, widx]

                nxt = _route(_features(xt, (w >> 16) & 0xFFF), w,
                             k_all[idx], thr_all[idx], cat_of, mw)
                cur = torch.where(live, torch.where(in_range, nxt.long(), 0),
                                  cur)
            slots = (~torch.clamp(cur, max=-1)).clamp(0, nl - 1)
            leaves[((t0 + sel)[:, None] * nl + slots).flatten()] = True

    def sectors(mask, size):
        at = torch.nonzero(mask).flatten() * size // 32
        return int(torch.unique(at).numel()) * 32

    nbytes = (b * f * 4 + t_trees * 16 + sectors(seen, 16)
              + (sectors(words, 4) if mw else 0) + sectors(leaves, vb)
              + b * n_class * vb)
    return nbytes, visits


def doctored_planes(stacked, seed):
    """A copy of the stacked planes `stacked` with feature ids past F,
    negative and past what a record holds, node ids past NI, and cycles
    (a root looping on itself, children pointing back to the root); the
    plain version's rules route them (ops/predict.py `_leaf_slots`)."""
    import torch
    rng = np.random.RandomState(seed)
    out = {k: v for k, v in stacked.items() if k != "rec"}
    feat, left, right = (stacked[k].clone() for k in ("feat", "left",
                                                      "right"))
    t_trees, ni = feat.shape
    for v in (6, 40, 4096, -1, -7, (1 << 28) - 1, (1 << 28) + 5,
              2 ** 31 - 1, -2 ** 31):
        feat[rng.randint(t_trees), rng.randint(ni)] = v
    for v in (ni, ni + 3, 2 ** 31 - 1):
        left[rng.randint(t_trees), rng.randint(ni)] = v
        right[rng.randint(t_trees), rng.randint(ni)] = v
    for t in rng.choice(t_trees, min(3, t_trees), replace=False):
        left[t, 0] = 0
        right[t, rng.randint(ni)] = 0
    out.update(feat=feat, left=left, right=right)
    return {k: v.contiguous() if isinstance(v, torch.Tensor) else v
            for k, v in out.items()}


#: the stacked traversal's launch plans serve_plane checks and times at
#: 1 and 4096 rows: (rows, trees) requests (None: the plan's)
STACKED_SWEEP = ((None, None), (8, None), (16, 32), (64, 8), (256, 2),
                 (None, 1), (None, 64))
#: the bounded sum's launch plans serve_plane checks and times at 1 and
#: 4096 rows: (rows, lanes, group_chunk) requests
BOUNDED_SWEEP = ((None, None, None), (None, None, 2), (1, None, None),
                 (4, None, None), (8, None, None), (32, None, None),
                 (None, 1, None), (None, 4, None), (16, 8, None))


def bounded_case(seed, t_trees, n_class, n_tiles, bits, n_rows, nl=255,
                 empty=3):
    """Slots [T, n_rows], codes [T, NL], tiles and scales of a synthetic
    bounded forest whose first classes lack trees in `empty` tiles each
    (numpy, from `seed`)."""
    rng = np.random.RandomState(seed)
    qmax = (1 << (bits - 1)) - 1
    slots = rng.randint(0, nl, (t_trees, n_rows)).astype(np.int32)
    qval = rng.randint(-qmax, qmax + 1, (t_trees, nl)).astype(
        np.int8 if bits == 8 else np.int16)
    tile = rng.randint(0, n_tiles, t_trees).astype(np.int32)
    cls = np.arange(t_trees) % n_class
    for k in range(min(n_class, 2)):
        for s in rng.choice(n_tiles, empty, replace=False):
            move = (cls == k) & (tile == s)
            tile[move] = (s + 1) % n_tiles
    scales = (rng.rand(n_tiles) * 10.0 ** rng.randint(-5, 1, n_tiles)
              ).astype(np.float32)
    return slots, qval, tile, scales


def _bounded_bytes(dev, b, K):
    """Bytes the bounded sum must move: one slot a tree and row (the
    trees' rows of the slots, read through `gather_idx`), the codes, the
    tile map and groups, the scales, the scores."""
    side = sum(int(t.numel() * t.element_size())
               for t in (dev.qval, dev.tile, dev.scales, dev.gidx)
               + tuple(dev.groups) if t is not None)
    return int(dev.qval.shape[0]) * b * 4 + side + b * K * 4


#: an HTTP client in a process of its own: reads [[thread, body], ...]
#: on stdin, posts each body to argv[1] + "/predict" from argv[2]
#: threads, writes [[seconds, response], ...] (or an error string) out
_HTTP_CLIENT = r"""
import json, sys, threading, time, urllib.request
base, nthreads = sys.argv[1], int(sys.argv[2])
plan = json.load(sys.stdin)
out = [None] * len(plan)
def run(t):
    for k, (tt, body) in enumerate(plan):
        if tt != t:
            continue
        try:
            req = urllib.request.Request(
                base + "/predict", data=body.encode(),
                headers={"Content-Type": "application/json"})
            t1 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=120) as r:
                data = r.read().decode()
            out[k] = [time.perf_counter() - t1, data]
        except Exception as e:
            out[k] = repr(e)
threads = [threading.Thread(target=run, args=(t,)) for t in range(nthreads)]
for th in threads:
    th.start()
for th in threads:
    th.join()
json.dump(out, sys.stdout)
"""


def _http_clients_in_a_process(base, threads, plan, timeout=600):
    """`_HTTP_CLIENT` run over `plan` in a Python process of its own (so
    the clients' JSON work shares no interpreter with the server's);
    the process is killed if it outlives `timeout`."""
    proc = subprocess.Popen([sys.executable, "-c", _HTTP_CLIENT, base,
                             str(threads)], stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, text=True)
    try:
        out, _ = proc.communicate(json.dumps(plan), timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    _check(proc.returncode == 0,
           f"serve_plane: the HTTP client process exited {proc.returncode}")
    return json.loads(out)


def _stage_medians(traces, results, http_ms):
    """Where an HTTP request's time went: the median of each serving
    stage of the server's request traces (`SERVE_RECORDER`, every
    request kept), their end-to-end median, and the median of the
    client's time less the server's end to end for the same request
    (matched by request id): the HTTP, JSON and socket share."""
    ok = {t["id"]: t for t in traces if t["status"] == "ok"}
    stages = sorted({s for t in ok.values() for s in t["stages_ms"]})
    outside = [ms - ok[r[1]["request_id"]]["e2e_ms"]
               for r, ms in zip(results, http_ms)
               if r[1]["request_id"] in ok]
    _check(len(outside) == len(results),
           f"serve_plane: {len(outside)} of {len(results)} requests have a "
           "server trace")
    return {"server_stage_p50_ms": {
                s: float(np.median([t["stages_ms"].get(s, 0.0)
                                    for t in ok.values()]))
                for s in stages},
            "server_e2e_p50_ms": float(np.median(
                [t["e2e_ms"] for t in ok.values()])),
            "client_less_server_p50_ms": float(np.median(outside))}


def phase_serve_plane(seed, device=None, timing=True, num_trees=500,
                      rows=TIMED_ROWS, http_threads=SERVE_HTTP_THREADS,
                      http_requests=SERVE_HTTP_REQUESTS):
    """The serving plane on the main phase's model (500 trees x 255
    leaves x 28 features, from `seed`): every rung pinned by options
    (compiled, device_sum, slot_path, bounded at 8 and 16 bits; the host
    walk on a narrow request) answering 1, 256 and 4096 rows between the
    counter reads; the stacked-plane traversal (`csrc/stacked.cu`) and
    the bounded sum (`csrc/bounded.cu`) bitwise their plain versions; the
    (q) model; the registry, batcher and HTTP front end under load; the
    fault cycle.  Returns the two kernels' kernels-line entries."""
    import threading
    import urllib.error
    import urllib.request
    import torch
    from lightgbm_tpu_torch import Booster, ServingRuntime
    from lightgbm_tpu_torch.compiler.kernel import traverse_all
    from lightgbm_tpu_torch.ops import predict
    from lightgbm_tpu_torch.resilience import FAULTS, DeviceTimeoutError
    from lightgbm_tpu_torch.serving import (
        ModelRegistry, ServingClient, ServingDeviceError, make_server)
    from lightgbm_tpu_torch.telemetry import REGISTRY, SERVE_RECORDER
    t_phase = time.perf_counter()
    dev = torch.device(device or "cuda")
    text = synthetic_forest_text(seed, num_trees=num_trees)
    bst = Booster(model_str=text)
    nf = bst.num_feature()
    rng = np.random.RandomState(seed + 5)
    reqs = {n: request_rows(rng, n) for n in rows}
    host = {n: (bst.predict(reqs[n], raw_score=True), bst.predict(reqs[n]))
            for n in rows}
    report = {"phase": "serve_plane", "trees": num_trees, "rungs": {}}

    # ---- 1. the main path: each rung, pinned, between the counter reads
    pins = {"compiled": {}, "device_sum": {"compiled": "off"},
            "slot_path": {"compiled": "off", "device_sum": "off"},
            "bounded": {"precision": "bounded"},
            "bounded16": {"precision": "bounded", "quant_bits": 16}}
    guard = guard_tree_text(text, nf, 40)
    g_bst = Booster(model_str=guard)
    _zero_serve_counters()
    rts, answers = {}, {}
    for name, opts in pins.items():
        t0 = time.perf_counter()
        rts[name] = ServingRuntime(bst, device=dev, name=name, **opts)
        rung = rts[name].rung
        _check(rung == name.replace("16", ""),
               f"serve_plane: {name} pinned, {rung} chosen")
        report["rungs"][name] = {"setup_s": time.perf_counter() - t0,
                                 "device_bytes": rts[name].device_bytes()}
        answers[name] = {n: (rts[name].predict(reqs[n], raw_score=True),
                             rts[name].predict(reqs[n])) for n in rows}
    for name, rt in rts.items():
        # only the rungs that launch the stacked traversal hold its
        # records: the compiled and bounded rungs' device bytes are theirs
        has = "rec" in (rt._state.dev.stacked or {})
        _check(has == (rt.rung in ("device_sum", "slot_path")
                       and dev.type == "cuda"),
               f"serve_plane: the {name} rung holds "
               f"{'' if has else 'no '}stacked records")
        report["rungs"][name]["records"] = has
    g_rt = ServingRuntime(g_bst, device=dev, name="guard")
    walked = REGISTRY.counter("serve.host_walk", cause="forced").value
    narrow = {n: g_rt.predict(reqs[n], raw_score=True) for n in rows}
    launches = _serve_counters()
    _check(REGISTRY.counter("serve.host_walk", cause="forced").value
           == walked + len(rows), "serve_plane: the narrow requests were "
           "not walked on the host")
    for k in ("serve", "stacked", "accumulate", "bounded", "traverse",
              "xla_link"):
        _check(launches[k] > 0, f"serve_plane: the main path launched no "
               f"{k} kernel: {launches}")
    report["launches"] = launches

    # answers: each exact rung bitwise the f64 host walk (f32-exact rows
    # and thresholds), raw and converted; the bounded rung within bound
    for name, rt in rts.items():
        rep = report["rungs"][name]
        for n in rows:
            raw, conv = answers[name][n]
            if rt.rung == "bounded":
                err = _max_abs_err(raw, host[n][0])
                rep.setdefault("max_abs_err_vs_f64", 0.0)
                rep["max_abs_err_vs_f64"] = max(rep["max_abs_err_vs_f64"],
                                                err)
                _check(err <= rt.bounded_bound and raw.dtype == np.float32,
                       f"serve_plane: {name} {n} rows: error {err} above "
                       f"the bound {rt.bounded_bound}")
                _check(_max_abs_err(conv, host[n][1]) <= rt.bounded_bound,
                       f"serve_plane: {name} {n} rows: converted scores "
                       "outside the bound")
            else:
                _check(_bits_equal(raw, host[n][0])
                       and _bits_equal(conv, host[n][1]),
                       f"serve_plane: {name} {n} rows != the f64 host walk")
        if rt.rung == "bounded":
            rep.update(bound=rt.bounded_bound,
                       probe_measured=rt.bounded_measured_error)
    for n in rows:
        # the guard tree adds its right leaf (0.125) after the 500 trees
        _check(_bits_equal(narrow[n], host[n][0] + 0.125),
               f"serve_plane: the narrow host walk at {n} rows != the "
               "model's walk")
    report["rungs"]["host_walk"] = {"requests": len(rows),
                                    "cause": "forced",
                                    "rung_of_runtime": g_rt.rung}

    # launches a request, and each rung's p50 by size
    big = max(rows)
    per_req = {}
    for name, rt in rts.items():
        _, raw_l = _counted(lambda: rt.predict(reqs[big], raw_score=True))
        _, conv_l = _counted(lambda: rt.predict(reqs[big]))
        per_req[name] = {"raw": raw_l, "converted": conv_l}
        if timing:
            p50 = {}
            for n in rows:
                ts = []
                for _ in range(SERVE_REPEATS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    rt.predict(reqs[n])
                    torch.cuda.synchronize()
                    ts.append(time.perf_counter() - t0)
                p50[str(n)] = float(np.median(ts)) * 1e3
            report["rungs"][name]["p50_ms"] = p50
    buckets = len(rts["compiled"]._state.meta)
    want = {"compiled": {"serve": 1, "xla_link": 1},
            "device_sum": {"stacked": 1, "accumulate": 1, "xla_link": 1},
            "slot_path": {"stacked": 1, "xla_link": 1},
            "bounded": {"traverse": buckets, "bounded": 1, "xla_link": 1},
            "bounded16": {"traverse": buckets, "bounded": 1, "xla_link": 1}}
    for name, w in want.items():
        _check(per_req[name]["converted"] == w,
               f"serve_plane: {name} launches a converted request "
               f"{per_req[name]['converted']}, want {w}")
    report["launches_per_request"] = per_req
    if timing:
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            g_rt.predict(reqs[256], raw_score=True)
            ts.append(time.perf_counter() - t0)
        report["rungs"]["host_walk"]["p50_ms_256"] = float(
            np.median(ts)) * 1e3

    # ---- 2. kernel A, the stacked-plane traversal, against its plain
    # version: the main model, the golden models with adversarial rows,
    # a categorical model with bitsets of several and of 313 words
    flush = _flusher(dev)
    ex = bst.export_predict_arrays(device=dev)
    stacked = predict.with_records(ex["stacked"])
    a_rows, a_err = {}, 0
    for b in rows:
        Xd = rts["compiled"]._stage32(reqs[b], b)
        k_sl, _ = _counted(lambda: predict.predict_leaf_ensemble(stacked, Xd))
        p_sl = predict.predict_leaf_ensemble_plain(stacked, Xd)
        a_err = max(a_err, int((k_sl - p_sl).abs().max()))
        _check(torch.equal(k_sl, p_sl),
               f"serve_plane: stacked traversal != plain at {b} rows")
        row = {"bytes": _stacked_bytes(ex, stacked, k_sl, nf)}
        row["bound_ms"], row["bound_by"] = _bound(
            row["bytes"], int(_leaf_visits(ex, k_sl)), INT32_OPS_PER_S)
        if timing:
            row["ms"] = _cuda_ms(lambda: predict.predict_leaf_ensemble(
                stacked, Xd), queued=True)
            row["cold_ms"] = _cuda_ms(lambda: predict.predict_leaf_ensemble(
                stacked, Xd), queued=True, flush=flush)
        a_rows[b] = row
    a_golden = {}
    goldens = [(name, open(os.path.join(
        ROOT, "tests", "data", f"golden_{name}.model.txt")).read())
        for name in GOLDEN]
    cat_text = dict(goldens)["categorical"]
    goldens += [("categorical_3_7_words", wide_bitset_text(cat_text, (3, 7))),
                ("categorical_313_words",
                 wide_bitset_text(cat_text, (313, 2), seed=1))]
    for name, gtext in goldens:
        g = Booster(model_str=gtext)
        gex = g.export_predict_arrays(device=dev)
        gex = dict(gex, stacked=predict.with_records(gex["stacked"]))
        gnf = max(g.num_feature(), gex["stacked"]["min_features"])
        X = adversarial_rows(g.trees, gnf, seed)
        if "words" in name:
            cats = np.random.RandomState(seed).randint(
                -3, 32 * 313 + 40, size=512).astype(np.float64)
            Xc = np.random.RandomState(seed + 1).randn(512, gnf)
            Xc[:, 0] = cats
            X = np.vstack([X, Xc])
        for b in (1, 256, 4096):
            Xb = np.resize(X, (b, gnf)) if b > len(X) else X[:b]
            Xd = rts["compiled"]._stage32(Xb, b)
            _check(torch.equal(
                predict.predict_leaf_ensemble(gex["stacked"], Xd),
                predict.predict_leaf_ensemble_plain(gex["stacked"], Xd)),
                f"serve_plane: stacked traversal != plain on {name}, {b} "
                "rows")
        a_golden[name] = {"rows": len(X), "mw": int(
            gex["stacked"]["cat_words"].shape[-1])
            if "cat_words" in gex["stacked"] else 0}
        if "words" not in name:
            # ROADMAP Queue 3 (i): the rows the served (f32-routed) raw
            # scores route otherwise than the f64 walk
            served = ServingRuntime(g, device=dev).predict(X, raw_score=True)
            walk = g.predict(X, raw_score=True)
            differ = (served.view(np.uint64) != walk.view(np.uint64))
            a_golden[name]["rows_differ_from_f64_walk"] = int(
                differ.reshape(len(X), -1).any(axis=1).sum())
    # doctored planes (feature ids past F, negative and past a record's
    # field, node ids past NI, cycles) on the main and two golden models,
    # their records rebuilt (`with_records`): bitwise the plain version
    a_doctored = {}
    for name, src in (("main", stacked),
                      ("categorical", Booster(model_str=cat_text)
                       .export_predict_arrays(device=dev)["stacked"]),
                      ("multiclass", Booster(model_str=dict(goldens)[
                          "multiclass"]).export_predict_arrays(
                              device=dev)["stacked"])):
        for dseed in range(3):
            dst = predict.with_records(doctored_planes(src, seed + dseed))
            for b in (1, 3, 256, 4096):
                Xb = np.resize(reqs[big], (b, nf))
                Xb[::5, :] = np.nan
                Xd = rts["compiled"]._stage32(Xb, b)
                _check(torch.equal(predict.predict_leaf_ensemble(dst, Xd),
                                   predict.predict_leaf_ensemble_plain(
                                       dst, Xd)),
                       f"serve_plane: stacked traversal != plain on the "
                       f"doctored {name} planes (seed {seed + dseed}, {b} "
                       "rows)")
        a_doctored[name] = {"seeds": 3, "rows": [1, 3, 256, 4096]}
    # the launch plans: each bitwise the plain version, timed warm
    from lightgbm_tpu_torch.compiler.records import (
        bounded_plan, stacked_plan)
    a_sweep = []
    for b in (1, big):
        Xd = rts["compiled"]._stage32(reqs[b], b)
        want = predict.predict_leaf_ensemble_plain(stacked, Xd)
        for r_req, t_req in STACKED_SWEEP:
            plan = stacked_plan(b, nf, int(stacked["feat"].shape[0]),
                                rows=r_req, trees=t_req)
            _check(torch.equal(predict.predict_leaf_ensemble(
                stacked, Xd, plan=plan), want),
                f"serve_plane: stacked traversal != plain at {b} rows "
                f"with {plan}")
            entry = {"rows": b, "plan": plan._asdict()}
            if timing:
                entry["ms"] = _cuda_ms(lambda: predict.predict_leaf_ensemble(
                    stacked, Xd, plan=plan), queued=True)
            a_sweep.append(entry)
    a_plain_ms = None
    if timing:
        Xd = rts["compiled"]._stage32(reqs[big], big)
        a_plain_ms = _cuda_ms(lambda: predict.predict_leaf_ensemble_plain(
            stacked, Xd), iters=3, warmup=1)
        a_rows[big]["plain_ms"] = a_plain_ms

    # ---- 3. kernel B, the bounded sum, against its plain version at 8
    # and 16 bits, raw and converted, on the bounded rung's own layout
    # (the standalone K6's slots read through gather_idx)
    conv_fn = bst.objective_.convert_output
    b_rows, b_err, b_bits = {}, 0.0, {}
    for name in ("bounded", "bounded16"):
        rt = rts[name]
        st = rt._state
        d = st.dev
        compiled_bytes = sum(int(a.numel() * a.element_size())
                             for bk in d.planes for a in bk
                             if a is not None)
        bounded_bytes = sum(int(t.numel() * t.element_size())
                            for t in (d.qval, d.tile, d.scales))
        _check(bounded_bytes <= compiled_bytes / 3,
               f"serve_plane: {name} planes {bounded_bytes} B, compiled "
               f"planes {compiled_bytes} B: not under a third")
        worst = 0.0
        for b in sorted(set(rows) | {1, 3}):
            Xb = reqs[b] if b in reqs else reqs[big][:b]
            Xd = rt._stage32(Xb, rt._chunk_rows(b))
            slots = traverse_all(Xd, d.planes, st.meta)
            args = (slots, d.qval, d.tile, d.scales, 1)
            k_out, _ = _counted(lambda: predict.accumulate_slots_bounded(
                *args, gather_idx=d.gidx, groups=d.groups))
            p_out = predict.accumulate_slots_bounded_plain(
                *args, gather_idx=d.gidx)
            b_err = max(b_err, _max_abs_err(k_out.cpu().numpy(),
                                            p_out.cpu().numpy()))
            _check(_bits_equal(k_out.cpu().numpy(), p_out.cpu().numpy()),
                   f"serve_plane: bounded sum != plain ({name}, {b} rows)")
            _check(_bits_equal(conv_fn(k_out).cpu().numpy(),
                               conv_fn(p_out).cpu().numpy()),
                   f"serve_plane: converted bounded sum != plain ({name})")
            cpu = predict.accumulate_slots_bounded_plain(
                *(a.cpu() for a in args[:4]), 1, gather_idx=d.gidx.cpu())
            _check(_bits_equal(k_out.cpu().numpy(), cpu.numpy()),
                   f"serve_plane: bounded sum on the card != the CPU "
                   f"({name}, {b} rows)")
            exact = predict.accumulate_slots_exact(slots, d.gidx,
                                                   ex["value_f64"])
            err = _max_abs_err(k_out.double().cpu().numpy(),
                               exact.cpu().numpy())
            worst = max(worst, err)
            _check(err <= rt.bounded_bound,
                   f"serve_plane: {name} error {err} above the bound "
                   f"{rt.bounded_bound}")
            if name == "bounded" and b in rows:
                row = {"bytes": _bounded_bytes(d, b, 1)}
                row["bound_ms"], row["bound_by"] = _bound(
                    row["bytes"], int(d.qval.shape[0]) * b,
                    DISPATCH_LANES_PER_S)
                if timing:
                    row["ms"] = _cuda_ms(
                        lambda: predict.accumulate_slots_bounded(
                            *args, gather_idx=d.gidx, groups=d.groups),
                        queued=True)
                    row["cold_ms"] = _cuda_ms(
                        lambda: predict.accumulate_slots_bounded(
                            *args, gather_idx=d.gidx, groups=d.groups),
                        queued=True, flush=flush)
                    if b == big:
                        row["plain_ms"] = _cuda_ms(
                            lambda: predict.accumulate_slots_bounded_plain(
                                *args, gather_idx=d.gidx), iters=3,
                            warmup=1)
                b_rows[b] = row
        b_bits[name] = {"bound": rt.bounded_bound, "max_abs_err": worst,
                        "bounded_plane_bytes": bounded_bytes,
                        "compiled_plane_bytes": compiled_bytes}

    # ---- 3b. kernel B on a multiclass model (the class loop over
    # `cls_start`): the bounded rung with `compiled` on and "off" (both
    # traverse the plan), at 8 and 16 bits, raw and converted; and the
    # stacked program (kernel A, then kernel B through the identity
    # gather) bitwise its plain version and the plan's bytes
    mc = Booster(model_str=dict(goldens)["multiclass"])
    mc_nf = max(mc.num_feature(),
                int(mc.export_predict_arrays()["stacked"]["min_features"]))
    mc_X = adversarial_rows(mc.trees, mc_nf, seed)
    mc_conv = mc.objective_.convert_output
    b_multiclass = {}
    for bits in (8, 16):
        for comp in ("on", "off"):
            rt = ServingRuntime(mc, device=dev, precision="bounded",
                                quant_bits=bits, compiled=comp)
            st, d = rt._state, rt._state.dev
            K = rt.num_class
            _check(rt.rung == "bounded" and K > 1,
                   f"serve_plane: multiclass bounded ({bits}, compiled "
                   f"{comp}) on {rt.rung}, K = {K}")
            worst = 0.0
            for b in (1, 256, 4096):
                Xb = np.resize(mc_X, (b, mc_nf))
                Xd = rt._stage32(Xb, rt._chunk_rows(b))
                slots = traverse_all(Xd, d.planes, st.meta)
                args = (slots, d.qval, d.tile, d.scales, K)
                k_out = predict.accumulate_slots_bounded(
                    *args, gather_idx=d.gidx, groups=d.groups)
                p_out = predict.accumulate_slots_bounded_plain(
                    *args, gather_idx=d.gidx)
                b_err = max(b_err, _max_abs_err(k_out.cpu().numpy(),
                                                p_out.cpu().numpy()))
                _check(_bits_equal(k_out.cpu().numpy(), p_out.cpu().numpy())
                       and _bits_equal(mc_conv(k_out).cpu().numpy(),
                                       mc_conv(p_out).cpu().numpy()),
                       f"serve_plane: multiclass bounded sum != plain "
                       f"({bits} bits, compiled {comp}, {b} rows)")
                s_out = predict.predict_raw_ensemble_bounded(
                    predict.with_records(d.stacked), Xd, d.qval, d.tile,
                    d.scales, K, groups=d.groups)
                s_plain = predict.accumulate_slots_bounded_plain(
                    predict.predict_leaf_ensemble_plain(d.stacked, Xd),
                    d.qval, d.tile, d.scales, K)
                _check(_bits_equal(s_out.cpu().numpy(),
                                   s_plain.cpu().numpy())
                       and _bits_equal(s_out.cpu().numpy(),
                                       k_out.cpu().numpy()),
                       f"serve_plane: the stacked bounded program != its "
                       f"plain version or the plan's ({bits} bits, {b} "
                       "rows)")
                served = rt.predict(Xb, raw_score=True)
                _check(_bits_equal(served, k_out[:b].cpu().numpy()),
                       f"serve_plane: multiclass bounded rung != kernel B "
                       f"({bits} bits, compiled {comp}, {b} rows)")
                # the exact f64 sum over the same (f32-routed) slots:
                # adversarial rows may route otherwise than the f64 walk
                exact = predict.accumulate_slots_exact(
                    slots, d.gidx, d.value_f64, K, d.stacked.get("cls"))
                err = _max_abs_err(served, exact[:b].cpu().numpy())
                worst = max(worst, err)
                _check(err <= rt.bounded_bound,
                       f"serve_plane: multiclass bounded error {err} above "
                       f"the bound {rt.bounded_bound}")
            b_multiclass[f"{bits}_compiled_{comp}"] = {
                "bound": rt.bounded_bound, "max_abs_err_vs_exact": worst,
                "exact_rung": rt.status()["exact_rung"]}

    # ---- 3c. kernel B on synthetic forests: classes that lack trees in
    # some tiles, 45 tiles, the groups in several chunks, and 100 classes
    # in blocks of 16 rows (partials past the default 48 KB of shared
    # memory at 256 and 4096 rows), at 8 and 16 bits and 1, 3, 256 and
    # 4096 rows: bitwise the plain version on the card and on the CPU;
    # then the plan sweep on the main model's
    b_synthetic = {}
    for label, (t_n, k_n, s_n, chunk, r_req) in {
            "lacking_tiles": (600, 3, 9, None, None),
            "tiles_45": (600, 2, 45, None, None),
            "chunks": (600, 3, 9, 4, None),
            "classes_100": (3000, 100, 30, None, 16)}.items():
        for bits in (8, 16):
            slots_np, qval_np, tile_np, scales_np = bounded_case(
                seed + bits, t_n, k_n, s_n, bits, big)
            lacking = sum(int(not ((np.arange(t_n) % k_n == k)
                                   & (tile_np == s_)).any())
                          for k in range(k_n) for s_ in range(s_n))
            _check(lacking > 0 or k_n == 1, f"serve_plane: {label} has no "
                   "tile that lacks a class")
            qd, td, sd = (torch.from_numpy(a).to(dev)
                          for a in (qval_np, tile_np, scales_np))
            groups = predict.bounded_groups(tile_np, k_n, dev, n_tiles=s_n)
            for b in (1, 3, 256, big):
                sl = torch.from_numpy(
                    np.ascontiguousarray(slots_np[:, :b])).to(dev)
                plan = bounded_plan(b, t_n, int(groups.grp_tile.shape[0]),
                                    k_n, rows=r_req, group_chunk=chunk)
                k_out = predict.accumulate_slots_bounded(
                    sl, qd, td, sd, k_n, groups=groups, plan=plan)
                p_out = predict.accumulate_slots_bounded_plain(
                    sl, qd, td, sd, k_n)
                cpu = predict.accumulate_slots_bounded_plain(
                    *(a.cpu() for a in (sl, qd, td, sd)), k_n)
                _check(_bits_equal(k_out.cpu().numpy(), p_out.cpu().numpy())
                       and _bits_equal(k_out.cpu().numpy(), cpu.numpy()),
                       f"serve_plane: bounded sum != plain on {label} "
                       f"({bits} bits, {b} rows, {plan})")
            _check(r_req is None or plan.optin, f"serve_plane: {label} "
                   f"did not opt in past 48 KB: {plan}")
            b_synthetic[f"{label}_{bits}"] = {
                "trees": t_n, "classes": k_n, "tiles": s_n,
                "groups": int(groups.grp_tile.shape[0]),
                "class_tiles_lacking": lacking, "plan_4096": plan._asdict()}
    b_sweep = []
    d = rts["bounded"]._state.dev
    n_groups = int(d.groups.grp_tile.shape[0])
    for b in (1, big):
        Xd = rts["bounded"]._stage32(reqs[b], rts["bounded"]._chunk_rows(b))
        slots = traverse_all(Xd, d.planes, rts["bounded"]._state.meta)
        args = (slots, d.qval, d.tile, d.scales, 1)
        want = predict.accumulate_slots_bounded_plain(*args,
                                                      gather_idx=d.gidx)
        for r_req, l_req, c_req in BOUNDED_SWEEP:
            plan = bounded_plan(int(slots.shape[1]), int(d.qval.shape[0]),
                                n_groups, 1, rows=r_req, lanes=l_req,
                                group_chunk=c_req)
            got = predict.accumulate_slots_bounded(
                *args, gather_idx=d.gidx, groups=d.groups, plan=plan)
            _check(_bits_equal(got.cpu().numpy(), want.cpu().numpy()),
                   f"serve_plane: bounded sum != plain at {b} rows with "
                   f"{plan}")
            entry = {"rows": b, "plan": plan._asdict()}
            if timing:
                entry["ms"] = _cuda_ms(
                    lambda: predict.accumulate_slots_bounded(
                        *args, gather_idx=d.gidx, groups=d.groups,
                        plan=plan), queued=True)
            b_sweep.append(entry)

    # ---- 4. the (q) model: feature 27 renamed 4096, past the plan's
    # 12-bit field: served on the device-sum rung, and device_predict
    # takes the stacked route
    q_text = _widen_text(text, 4097, feature_map={nf - 1: 4096})
    q_bst, q_cpu = Booster(model_str=q_text), Booster(model_str=q_text)
    Xq = np.zeros((256, 4097))
    Xq[:, :nf - 1] = reqs[256][:, :nf - 1]
    Xq[:, 4096] = reqs[256][:, nf - 1]
    q_host = q_bst.predict(Xq, raw_score=True)
    _check(_bits_equal(q_host, host[256][0]),
           "serve_plane: the (q) model's walk != the main model's")
    (q_rt, q_rt_l) = _counted(lambda: ServingRuntime(q_bst, device=dev))
    _check(q_rt.rung == "device_sum"
           and q_rt.status()["cause"] == "plan_refused",
           f"serve_plane: the (q) model is served on {q_rt.rung}")
    q_raw, q_l = _counted(lambda: q_rt.predict(Xq, raw_score=True))
    _check(_bits_equal(q_raw, q_host),
           "serve_plane: the (q) model served != its f64 walk")
    q_dp, q_dp_l = _counted(lambda: q_bst.predict(
        Xq, raw_score=True, device_predict=True, device_type=dev.type))
    _check(q_dp_l.get("device_predict_stacked") == 1
           and q_dp_l.get("stacked") == 1,
           f"serve_plane: (q) device_predict launches {q_dp_l}")
    _check(_bits_equal(q_dp, q_cpu.predict(Xq, raw_score=True,
                                           device_predict=True,
                                           device_type="cpu")),
           "serve_plane: (q) device_predict on the card != the CPU")
    q_st = q_bst._device_predict_state(0, None, dev)
    Xqd = torch.from_numpy(Xq.astype(np.float32)).to(dev)
    _check(torch.equal(predict.predict_leaf_ensemble(q_st.stacked, Xqd),
                       predict.predict_leaf_ensemble_plain(q_st.stacked,
                                                           Xqd)),
           "serve_plane: (q) stacked traversal != plain")
    report["q_model"] = {"rung": q_rt.rung, "refresh_launches": q_rt_l,
                         "request_launches": q_l,
                         "device_predict_launches": q_dp_l,
                         "max_abs_diff_device_predict_vs_walk":
                             _max_abs_err(q_dp, q_host)}

    # ---- 5. the front end: registry + batcher + HTTP under 8 threads
    reg = ModelRegistry({"serve_warmup": True, "serve_max_wait_ms": 1.0,
                         "serve_breaker_backoff_s": 0.2,
                         "serve_queue_depth": 4096,
                         "device_type": dev.type})
    t0 = time.perf_counter()
    client = ServingClient(registry=reg)
    client.load("default", bst)
    load_s = time.perf_counter() - t0
    rt = reg.get("default").runtime
    srv = make_server(client, "127.0.0.1", 0)
    srv_t = threading.Thread(target=srv.serve_forever, daemon=True)
    srv_t.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    pool = request_rows(np.random.RandomState(seed + 6), 4096)

    def post(X, raw, timeout=120):
        data = json.dumps({"rows": X.tolist(), "raw_score": raw}).encode()
        req = urllib.request.Request(
            base + "/predict", data=data,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read())

    plan = []
    prng = np.random.RandomState(seed + 7)
    for t in range(http_threads):
        for i in range(http_requests):
            n = int(prng.randint(1, SERVE_HTTP_MAX_ROWS + 1))
            lo = int(prng.randint(0, len(pool) - n + 1))
            plan.append((t, lo, n, bool(i % 2)))
    bodies = [json.dumps({"rows": pool[lo:lo + n].tolist(),
                          "raw_score": raw}) for _, lo, n, raw in plan]
    recorder_was = (SERVE_RECORDER.capacity, SERVE_RECORDER.sample_every)
    SERVE_RECORDER.configure(capacity=len(plan) + 64, sample_every=1)

    def in_process():
        results = [None] * len(plan)
        errors = []

        def client_thread(t):
            try:
                for k, (tt, lo, n, raw) in enumerate(plan):
                    if tt != t:
                        continue
                    t1 = time.perf_counter()
                    body = post(pool[lo:lo + n], raw)
                    results[k] = (time.perf_counter() - t1, body)
            except Exception as e:  # reported after the join
                errors.append(repr(e))

        threads = [threading.Thread(target=client_thread, args=(t,))
                   for t in range(http_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(600)
        return results, errors

    def out_of_process():
        out = _http_clients_in_a_process(base, http_threads, [
            (t, b) for (t, _, _, _), b in zip(plan, bodies)])
        errors = [r for r in out if not isinstance(r, list)]
        return ([(r[0], json.loads(r[1])) if isinstance(r, list) else None
                 for r in out], errors)

    def out_of_process_short_switch():
        # the interpreter lock handed over every 0.2 ms, not 5 ms: how
        # much of the server's time is waiting for the lock
        was = sys.getswitchinterval()
        sys.setswitchinterval(HTTP_SHORT_SWITCH_S)
        try:
            return out_of_process()
        finally:
            sys.setswitchinterval(was)

    runs = {}
    for name, run in (("clients_in_process", in_process),
                      ("clients_in_a_process", out_of_process),
                      ("clients_in_a_process_switch_0.2ms",
                       out_of_process_short_switch)):
        SERVE_RECORDER.clear()
        rows0 = REGISTRY.counter("serve.rows").value
        batches0 = REGISTRY.counter("serve.batches").value
        t0 = time.perf_counter()
        results, errors = run()
        wall = time.perf_counter() - t0
        _check(not errors and all(r is not None for r in results),
               f"serve_plane: HTTP clients ({name}) failed: {errors[:3]}")
        batches = REGISTRY.counter("serve.batches").value - batches0
        served_rows = REGISTRY.counter("serve.rows").value - rows0
        http_ms = [r[0] * 1e3 for r in results]
        runs[name] = {
            "wall_s": wall, "requests_per_s": len(plan) / wall,
            "p50_ms": float(np.percentile(http_ms, 50)),
            "p99_ms": float(np.percentile(http_ms, 99)),
            "batches": batches,
            "rows_per_batch": served_rows / max(batches, 1),
            **_stage_medians(SERVE_RECORDER.snapshot()["requests"],
                             results, http_ms)}
        runs[name]["results"] = results
    direct_ms, json_ms = [], []
    for k, (_, lo, n, raw) in enumerate(plan):
        t1 = time.perf_counter()
        want_k = rt.predict(pool[lo:lo + n], raw_score=raw)
        direct_ms.append((time.perf_counter() - t1) * 1e3)
        # the handler's own Python work around the trace, alone: the
        # body parsed into rows, the answer written as JSON
        t1 = time.perf_counter()
        np.asarray(json.loads(bodies[k])["rows"], np.float64)
        json.dumps({"model": "default", "rows": n,
                    "predictions": np.asarray(want_k).tolist(),
                    "request_id": "0" * 32}).encode()
        json_ms.append((time.perf_counter() - t1) * 1e3)
        for name, r in runs.items():
            got = np.asarray(r["results"][k][1]["predictions"],
                             np.float64 if raw else np.float32)
            _check(_bits_equal(got, want_k),
                   f"serve_plane: HTTP response {k} ({name}) != the "
                   "runtime's answer")
    for r in runs.values():
        del r["results"]
    SERVE_RECORDER.configure(capacity=recorder_was[0],
                             sample_every=recorder_was[1])
    hz = json.loads(urllib.request.urlopen(base + "/healthz",
                                           timeout=60).read())
    metrics = urllib.request.urlopen(base + "/metrics",
                                     timeout=60).read().decode()
    _check(hz["status"] == "ok" and hz["rungs"]["default"]["rung"]
           == "compiled" and hz["device_bytes"]["default"] > 0,
           f"serve_plane: /healthz {hz}")
    _check("lgbm_tpu_serve_rows" in metrics,
           "serve_plane: /metrics lacks the serving counters")
    # the memory ledger: the model's planes attributed, within what the
    # allocator holds
    with urllib.request.urlopen(base + "/debug/memory", timeout=60) as r:
        mem_status, memory = r.status, json.loads(r.read())
    dkey = f"dev{dev.index or 0}" if dev.type == "cuda" else "host"
    planes = {k: v["bytes"] for k, v in memory["devices"].get(
        dkey, {}).get("owners", {}).items()
        if k.startswith("serve.default.planes")}
    alloc = memory["reconcile"]["devices"].get(dkey, {}).get(
        "allocator_bytes")
    _check(mem_status == 200 and sum(planes.values()) > 0
           and (dev.type != "cuda" or sum(planes.values()) <= alloc),
           f"serve_plane: /debug/memory {mem_status}, planes {planes}, "
           f"allocator {alloc}")
    report["http"] = {
        "requests": len(plan), "threads": http_threads, "load_s": load_s,
        **runs.pop("clients_in_process"), **runs,
        "handler_json_p50_ms": float(np.median(json_ms)),
        "handler_json_s_total": float(np.sum(json_ms)) / 1e3,
        "direct_p50_ms": float(np.percentile(direct_ms, 50)),
        "direct_p99_ms": float(np.percentile(direct_ms, 99)),
        "healthz": hz, "metrics_lines": len(metrics.splitlines()),
        "debug_memory": {"status": mem_status, "planes": planes,
                         "allocator_bytes": alloc,
                         "source": memory["reconcile"]["source"]}}

    # ---- 6. faults, armed after the load
    X5 = pool[:5]
    before = post(X5, True)["predictions"]
    errs0 = REGISTRY.counter("serve.device_errors", rung="compiled").value
    walks0 = sum(c.value for c in REGISTRY.counter_family(
        "serve.host_walk"))
    FAULTS.arm("serve.dispatch.compiled:error")
    try:
        post(X5, True)
        _check(False, "serve_plane: an injected error did not fail the "
               "request")
    except urllib.error.HTTPError as e:
        _check(e.code == 503 and e.headers.get("Retry-After") is not None,
               f"serve_plane: injected error answered {e.code}")
    states = rt.breaker_states()
    _check(states["compiled"] == "open"
           and all(s == "closed" for r, s in states.items()
                   if r != "compiled"),
           f"serve_plane: breakers after the fault {states}")
    _check(REGISTRY.counter("serve.device_errors", rung="compiled").value
           == errs0 + 1 and sum(c.value for c in REGISTRY.counter_family(
               "serve.host_walk")) == walks0,
           "serve_plane: the fault was not counted, or a lower rung answered")
    FAULTS.disarm()
    time.sleep(0.25)                     # past the 0.2 s backoff
    try:
        post(X5, True)                   # fails fast, starts the re-probe
        _check(False, "serve_plane: a request passed an open breaker")
    except urllib.error.HTTPError as e:
        _check(e.code == 503, f"serve_plane: open breaker answered {e.code}")
    rt.join_reprobes(timeout=120)
    _check(rt.breaker_states()["compiled"] == "closed",
           "serve_plane: the re-probe did not close the breaker")
    after = post(X5, True)["predictions"]
    _check(after == before, "serve_plane: bytes after recovery differ")
    h_rt = ServingRuntime(bst, device=dev, name="watchdog",
                          dispatch_timeout_ms=500.0)
    fired0 = REGISTRY.counter("serve.watchdog.fired",
                              site="serve.dispatch.compiled").value
    FAULTS.arm("serve.dispatch.compiled:hang")
    try:
        try:
            h_rt.predict(X5)
            _check(False, "serve_plane: a hang was not bounded")
        except ServingDeviceError as e:
            _check(isinstance(e.__cause__, DeviceTimeoutError),
                   f"serve_plane: hang raised {e.__cause__!r}")
    finally:
        FAULTS.disarm()
    _check(REGISTRY.counter("serve.watchdog.fired",
                            site="serve.dispatch.compiled").value
           == fired0 + 1, "serve_plane: the watchdog did not count")
    report["faults"] = {"error_http": 503, "open_then_recovered": True,
                        "bytes_after_recovery_equal": True,
                        "hang_bounded_ms": 500.0}
    srv.shutdown()
    srv.server_close()
    srv_t.join(60)
    client.close()

    report["kernels_by_rows"] = {"stacked_slots": {str(b): a_rows[b]
                                                   for b in rows},
                                 "accumulate_bounded": {
                                     str(b): b_rows[b] for b in rows}}
    report["stacked_golden"] = a_golden
    report["stacked_doctored"] = a_doctored
    report["stacked_plans"] = a_sweep
    report["bounded"] = b_bits
    report["bounded_multiclass"] = b_multiclass
    report["bounded_synthetic"] = b_synthetic
    report["bounded_plans"] = b_sweep
    report["phase_s"] = time.perf_counter() - t_phase
    _emit(report)
    big_a, big_b = a_rows[big], b_rows[big]
    return [
        {"name": "stacked_slots", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/stacked.cu",
         "replaces": "lightgbm_tpu/ops/predict.py:114",
         "launches": launches["stacked"], "max_abs_err": float(a_err),
         "ms": big_a.get("ms"), "plain_ms": a_plain_ms,
         "bound_ms": big_a["bound_ms"], "bound_by": big_a["bound_by"],
         "library_ms": None,
         "library_note": "no torch call walks trees", "rows": big,
         "ms_by_rows": {str(b): a_rows[b].get("ms") for b in rows},
         "cold_ms_by_rows": {str(b): a_rows[b].get("cold_ms")
                             for b in rows},
         "bound_ms_by_rows": {str(b): a_rows[b]["bound_ms"] for b in rows}},
        {"name": "accumulate_bounded", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/bounded.cu",
         "replaces": "lightgbm_tpu/ops/predict.py:567",
         "launches": launches["bounded"], "max_abs_err": b_err,
         "ms": big_b.get("ms"), "plain_ms": big_b.get("plain_ms"),
         "bound_ms": big_b["bound_ms"], "bound_by": big_b["bound_by"],
         "library_ms": None,
         "library_note": "no torch call sums per (tile, class) and "
                         "combines in this order", "rows": big,
         "ms_by_rows": {str(b): b_rows[b].get("ms") for b in rows},
         "cold_ms_by_rows": {str(b): b_rows[b].get("cold_ms")
                             for b in rows},
         "bound_ms_by_rows": {str(b): b_rows[b]["bound_ms"] for b in rows},
         "max_abs_err_vs_exact": {n: v["max_abs_err"]
                                  for n, v in b_bits.items()},
         "published_bound": {n: v["bound"] for n, v in b_bits.items()}},
    ]


def _leaf_visits(ex, slots):
    """Internal nodes visited by the rows of `slots` [T, B]: the sum of
    their leaves' depths."""
    trees = ex["trees"]
    nl = ex["leaf_values"].shape[1]
    depth = _leaf_depths(trees, nl)
    s = slots.cpu().numpy().clip(0, nl - 1)
    return int(np.take_along_axis(depth, s, axis=1).sum())


def _record_visits(ex, slots):
    """Records the fused walks read for the rows of `slots` [T, B]: each
    leaf's depth, and the root of a single-leaf tree (a record that
    sends every row to leaf 0)."""
    trees = ex["trees"]
    nl = ex["leaf_values"].shape[1]
    depth = np.maximum(_leaf_depths(trees, nl), 1)
    s = slots.cpu().numpy().clip(0, nl - 1)
    return int(np.take_along_axis(depth, s, axis=1).sum())


def _without_params(text):
    """A model text less its `[key: value]` parameter lines."""
    return "\n".join(ln for ln in text.splitlines() if not ln.startswith("["))


#: the phases that hold one kernel against its plain version on the
#: train phase's data, runnable alone with --phases; `compare` needs
#: --baseline
KERNEL_PHASES = {"golden": lambda d, s, b: phase_golden(s),
                 "main": lambda d, s, b: _phase_main_alone(s),
                 "objective": lambda d, s, b: phase_objective(s),
                 "histogram": lambda d, s, b: phase_histogram(d(), s),
                 "fused": lambda d, s, b: phase_fused(d(), s),
                 "histogram_q": lambda d, s, b: phase_histogram_q(d(), s),
                 "fused_q": lambda d, s, b: phase_fused_q(d(), s),
                 "threefry": lambda d, s, b: phase_threefry(s),
                 "train_sampled": lambda d, s, b: phase_train_sampled(
                     d(), _train_modules()),
                 "train_categorical": lambda d, s, b:
                     phase_train_categorical(CatData(s), _train_modules()),
                 "train_api": lambda d, s, b: phase_train_api(
                     d(), _train_modules()),
                 "train_breadth": lambda d, s, b: phase_train_breadth(
                     d(), _train_modules()),
                 "train_objectives": lambda d, s, b:
                     phase_train_objectives(d(), _train_modules()),
                 "train_rank": lambda d, s, b: phase_train_rank(
                     RankData(s), _train_modules()),
                 "train_sparse": lambda d, s, b: phase_train_sparse(
                     s, _train_modules()),
                 "train_files": lambda d, s, b: phase_train_files(
                     d(), _train_modules(), seed=s),
                 "train_stream": lambda d, s, b: phase_train_stream(
                     d(), _train_modules()),
                 "train_dist": lambda d, s, b: phase_train_dist(d()),
                 "serve_sharded": lambda d, s, b: phase_serve_sharded(s),
                 "predict_api": lambda d, s, b: phase_predict_api(s),
                 "serve_plane": lambda d, s, b: phase_serve_plane(s),
                 "compare": lambda d, s, b: (phase_compare(d(), s, b),
                                             phase_compare_serving(s, b)),
                 "compare_serving":
                     lambda d, s, b: phase_compare_serving(s, b)}
#: the phases that compare with --baseline
COMPARE_PHASES = ("compare", "compare_serving")


def _train_modules():
    import lightgbm_tpu_torch.ops.fused_kernel as fused_module
    import lightgbm_tpu_torch.ops.hist_kernel as hist_module
    import lightgbm_tpu_torch.ops.hist_kernel_q as hist_q_module
    return {"hist": hist_module, "hist_q": hist_q_module,
            "fused": fused_module}


def _phase_main_alone(seed):
    import lightgbm_tpu_torch.compiler.kernel as kernel_module
    import lightgbm_tpu_torch.ops.predict as predict_module
    return phase_main(seed, kernel_module, predict_module)


def _run_phases(names, seed, baseline=None) -> int:
    """Build the kernels and run the named phases (the train phase's
    data is made once, for the first phase that needs it); 0 if every
    check passed."""
    unknown = [n for n in names if n not in KERNEL_PHASES]
    if unknown or (set(names) & set(COMPARE_PHASES) and not baseline):
        print(f"chip_smoke: unknown phases {unknown}, or compare without "
              "--baseline", file=sys.stderr)
        return 2
    made = []

    def data():
        if not made:
            made.append(TrainData(seed))
        return made[0]

    try:
        phase_env()
        for name in names:
            KERNEL_PHASES[name](data, seed, baseline)
        _emit(dict(phase="walls", **_phase_walls()))
    except Failure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=None,
                    help="comma-separated kernel phases to run alone "
                    f"({','.join(KERNEL_PHASES)}): their lines only, no "
                    "kernels line and no final line")
    ap.add_argument("--dist-worker", nargs=4, default=None,
                    metavar=("RANK", "WORLD", "STORE", "JOB"),
                    help="run one rank of the train_dist phase (the phase "
                    "starts these itself)")
    ap.add_argument("--baseline", default=None,
                    help="another checkout whose K1, K2, K4, K5, carry "
                    "and serving kernels the compare phases time beside "
                    "this one's")
    args = ap.parse_args(argv)
    if args.dist_worker:
        sys.path.insert(0, ROOT)
        r, w, store, job = args.dist_worker
        return dist_worker(int(r), int(w), store, job)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        import lightgbm_tpu_torch.compiler.kernel as kernel_module
        import lightgbm_tpu_torch.ops.fused_kernel as fused_module
        import lightgbm_tpu_torch.ops.hist_kernel as hist_module
        import lightgbm_tpu_torch.ops.hist_kernel_q as hist_q_module
        import lightgbm_tpu_torch.ops.predict as predict_module
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 1
    if args.phases:
        return _run_phases(args.phases.split(","), args.seed, args.baseline)
    try:
        smi = phase_env()
        golden = phase_golden(args.seed)
        kernels, link_launches, link_err = phase_main(
            args.seed, kernel_module, predict_module)
        for k in kernels:                # the standalone entries' golden
            if k["name"] in ("traverse", "accumulate_exact"):   # launches
                k["golden_launches"] = golden[k["name"].split("_")[0]]
        predict_entries, predict_launches = phase_predict_api(args.seed)
        for k in kernels:      # 0 since device_predict's fused route
            if k["name"] in ("traverse", "accumulate_exact"):
                k["predict_api_launches"] = predict_launches[
                    k["name"].split("_")[0]]
        kernels += predict_entries
        kernels += phase_serve_plane(args.seed)
        link = phase_objective(args.seed)
        link["launches"] = link_launches
        link["max_abs_err"] = max(link["max_abs_err"], link_err)
        kernels.append(link)
        data = TrainData(args.seed)
        hist = phase_histogram(data, args.seed)
        launches = phase_train(data, {"hist": hist_module,
                                      "kernel": kernel_module,
                                      "predict": predict_module})
        hist["launches"] = launches["histogram"]
        kernels.append(hist)
        fused = phase_fused(data, args.seed)
        wave, wave_report = phase_train_wave(data, {"hist": hist_module,
                                                    "fused": fused_module})
        for name in ("fused_hist_split", "split_scan"):
            fused[name]["launches"] = wave[name]
            kernels.append(fused[name])
        hist_q = phase_histogram_q(data, args.seed)
        fused_q = phase_fused_q(data, args.seed)
        quant = phase_train_quant(data, {"hist": hist_module,
                                         "hist_q": hist_q_module,
                                         "fused": fused_module},
                                  f32_wave=wave_report)
        hist_q["launches"] = quant["histogram_q"]
        fused_q["launches"] = quant["fused_hist_split_q"]
        kernels += [hist_q, fused_q]
        draws = phase_threefry(args.seed)
        draws["launches"] = phase_train_sampled(
            data, {"hist": hist_module, "hist_q": hist_q_module,
                   "fused": fused_module}, f32_wave=wave_report)
        draws["quantize_launches"] = quant["threefry"]
        kernels.append(draws)
        phase_train_categorical(CatData(args.seed), {
            "hist": hist_module, "hist_q": hist_q_module,
            "fused": fused_module})
        api = phase_train_api(data, {"hist": hist_module,
                                     "hist_q": hist_q_module,
                                     "fused": fused_module},
                              wave_report=wave_report)
        for k in kernels:
            if k["name"] in api:
                k["train_api_launches"] = api[k["name"]]
        breadth = phase_train_breadth(data, {"hist": hist_module,
                                             "hist_q": hist_q_module,
                                             "fused": fused_module})
        for k in kernels:
            if k["name"] in breadth:
                k["train_breadth_launches"] = breadth[k["name"]]
        modules = {"hist": hist_module, "hist_q": hist_q_module,
                   "fused": fused_module}
        for phase, got in (
                ("train_objectives", phase_train_objectives(data, modules)),
                ("train_rank", phase_train_rank(RankData(args.seed),
                                                modules)),
                ("train_sparse", phase_train_sparse(args.seed, modules)),
                ("train_files", phase_train_files(data, modules,
                                                  seed=args.seed))):
            for k in kernels:
                if k["name"] in got:
                    k[f"{phase}_launches"] = got[k["name"]]
        kernels += phase_train_stream(data, modules)
        dist = phase_train_dist(data)
        sharded = phase_serve_sharded(args.seed)
        for k in kernels:
            if k["name"] in dist:
                k["train_dist_launches"] = dist[k["name"]]
            if k["name"] == "serve_forest":
                k["serve_sharded_launches"] = sharded
        _emit({"phase": "kernels", "kernels": [
            {"name": k["name"], "launches": k["launches"],
             "parity": ("within_tol" if k["name"] in WITHIN_TOL
                        else "bitwise" if k["max_abs_err"] == 0
                        else "differs")}
            for k in kernels]})
        _emit(dict(phase="walls", **_phase_walls()))
        _emit({"kernels": kernels})
    except Failure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(smi, flush=True)
    _emit({"ok": True, "device": {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
