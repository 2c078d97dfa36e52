#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``transmogrifai_tpu_torch``) on one
NVIDIA GPU: builds the hand-written kernels from ``csrc/``, holds each one
against its plain PyTorch version, then drives the ported AutoML paths end
to end at full width through the entry points a user calls:

    FeatureBuilder -> transmogrify -> SanityChecker -> OpXGBoostClassifier
    -> OpWorkflow.train() -> score_and_evaluate(AuPR)

    FeatureBuilder -> transmogrify -> SanityChecker
    -> BinaryClassificationModelSelector.with_cross_validation()
    -> OpWorkflow.train() -> score_and_evaluate(AuPR)

    FeatureBuilder (Real, Integral, PickList) -> transmogrify
    -> SanityChecker -> RegressionModelSelector.with_cross_validation()
    -> OpWorkflow.train() -> score_and_evaluate(RMSE, R2)
    -> save -> load -> score, local scorer

    FeatureBuilder -> feature arithmetic, vectorize -> transmogrify
    (SmartText hashing, pivots, reals, integrals, a vector)
    -> SanityChecker -> BinaryClassificationModelSelector (the Titanic
    demo's grid) -> OpWorkflow.train() -> score_and_evaluate(AuPR)
    -> save -> load -> local scorer -> ModelServer

    OpWorkflow().with_raw_feature_filter(scoring_data=...) over the
    Titanic demo with two planted bad features -> train() (the DAG lint,
    RawFeatureFilter, the DAG) -> model_insights() -> RecordInsightsLOCO,
    RecordInsightsCorr -> save -> load; SanityChecker(correlation_type=
    "spearman"); train() refusing a leaky and a dangling DAG

    FeatureBuilder (the Titanic columns, Email, EmailMap, Phone, Bio,
    Boarded) -> tokenize, remove_stop_words, ngrams, hashing_tf,
    word2vec, OpCountVectorizer -> lda, auto_bucketize (the kernel at
    d = 1), zscore, fill_missing_with_mean, calibrate_percentile, the
    email, phone and language detectors, to_time_period,
    jaccard_similarity, transmogrify -> VectorsCombiner
    -> MinVarianceFilter -> SanityChecker
    -> BinaryClassificationModelSelector.with_cross_validation()
    -> OpWorkflow.train() -> score_and_evaluate(AuPR, the full binary
    metric set) -> save -> load -> score

    write_avro -> OpWorkflow.set_reader(AvroReader) -> FeatureBuilder
    -> transmogrify -> SanityChecker -> two
    BinaryClassificationModelSelector.with_cross_validation() (LR + MLP,
    forests) -> SelectedModelCombiner("weighted") -> OpWorkflow.train()
    -> score -> AuPR -> save -> load -> score; OpLinearSVC and
    OpNaiveBayes -> fit_raw -> predict_batch

    CSVReader -> FeatureBuilder -> transmogrify -> SanityChecker
    -> OpNaiveBayes -> OpWorkflow.train(chunk_rows=4096) (every stage
    streamed) and train(); with_raw_feature_filter -> transmogrify
    -> SanityChecker -> BinaryClassificationModelSelector
    .with_cross_validation() -> train(chunk_rows=65536) (the selector
    in-core on the streamed matrix) -> save -> load -> ModelServer
    .with_drift_monitor(DriftMonitor.from_model)

    JSONL clickstream -> ConditionalDataReader (in-core) and
    StreamingConditionalReader(JSONLinesReader) -> FeatureBuilder
    .extract(event_field=).aggregate() -> transmogrify -> SanityChecker
    -> BinaryClassificationModelSelector.with_cross_validation()
    -> OpWorkflow.train() and train(chunk_rows=4096); with_resilience
    (quarantine, RetryPolicy), TM060, DriftMonitor

    python -m transmogrifai_tpu_torch gen -> the generated App
    (OpApp/OpWorkflowRunner: train, evaluate) -> run.py --run-type score

    FeatureBuilder -> transmogrify -> SanityChecker
    -> MultiClassificationModelSelector.with_cross_validation()
    -> OpWorkflow.train() -> score_and_evaluate(F1)
    -> save -> load -> local scorer -> ModelServer

    FeatureBuilder -> transmogrify -> SanityChecker
    -> MultiClassificationModelSelector.with_cross_validation(
       models_and_parameters=[softmax XGBoost, decision trees])
    -> OpWorkflow.train() -> score_and_evaluate(F1)
    -> save -> load -> local scorer -> ModelServer;
    OpXGBoostClassifier (K classes), OpGBTClassifier (count-gated) and
    OpXGBoostClassifier (subsampled) -> fit_raw -> predict_batch

    OpGeneralizedLinearRegression (poisson) -> fit_raw -> predict_batch;
    IsotonicRegressionCalibrator -> fit_raw -> predict_batch

    OpXGBoostClassifier (the reference's defaults) -> fit_raw on 250k x 2000
    wide sparse rows (BASELINE.md config 5) -> predict_batch; the same
    with TMOG_SPARSE_HIST=1 (the CSR histogram) and with TMOG_EFB

    FeatureBuilder (4 Reals) -> transmogrify -> SanityChecker
    -> MultiClassificationModelSelector.with_train_validation_split()
       (LR, MLP: the Iris demo) -> OpWorkflow.train() -> F1

    model.save -> OpWorkflowModel.load -> score (batch, CSVReader)
    -> ModelServer (batch 1, a burst, batch 64) -> HTTP

    ModelServer(device_programs=True, aot_store=...) (a CUDA graph per
    bucket; a fresh replica loads the store) -> the host rung after a
    device fault -> GuardedSwap (shadow gates, pinned swap, bake,
    rollback) -> MultiTenantServer (quotas, weighted-fair dequeue) -> HTTP

Phases (one JSON line each, after a ``device`` line that also derives the
card's aggregate shared-memory rate):
  1. build      nvcc for sm_90a of csrc/seg_hist.cu; the ptxas report, which
                must show no register spills
  2. tree       grow_tree at 50 000 x 64, depth 6, through the kernel, the
                plain version on the card and the plain version on the CPU:
                identical splits; growth through the kernel raises nothing
                under torch.cuda's sync debug mode "error" (a prototype that
                does not catch every synchronising op); a random-forest
                grid (grow_rf_grid, 3 folds x 2 gates x 3 trees, depth 8,
                8-feature subsets) through the kernel and the plain version
                on the card: identical trees
  3. slice      1 000 000 train + 100 000 held-out rows x 500 Real
                features (the recipe of examples/bench_scale.py, seed 11;
                made once for this and the next phase, ``data_s``),
                XGBoost defaults with max_depth=6; per-phase walls, rounds,
                ms per round, holdout AuPR, kernel launches, peak memory
  4. selector   the same data through the default binary model selector:
                LR (4 x 2) and random-forest (3 x 2 x 3, 50 trees) grids
                under 3-fold CV, the winner refit; the train's split by
                stage and sweep group, every candidate's CV metric, the
                summary's metrics, holdout AuPR, trees grown and kernel
                launches against the growers' count, peak memory, the
                tree-prep prefetch thread's seconds
                (``prefetchTreePrepSecs``) and its state after the fit
                (it must be joined)
  4a. obs       observability, after the selector phase: the default
                selector on the first OBS_ROWS (50 000) of its training
                rows, untraced, then under obs.start_trace() with the
                per-stage kernel mix (torch.profiler around each serial
                stage), both in a child (``--obs-child``: kineto's clock,
                started by a first profiler session, lets device events
                of sessions many minutes later fall outside their
                windows, and the seg_hist and profile phases' sessions
                come later in this process); both walls and the traced
                overhead; the Chrome export valid with no dropped span;
                the span categories (workflow, plan, stage, sweep at
                least); the selector stage's profiled seg_hist_groups
                and seg_hist_reduce kernels (one of each a launch) equal
                to its seg_hist launches, and its summed kernel time
                against its wall; the transfer ledger (launches by tag
                against the counter); the disabled hooks' cost
                (estimate_disabled_overhead_s over the traced run's
                spans and events) under OBS_FRAC_LIMIT of the untraced
                wall; the same winner traced and untraced. Then
                ``python -m transmogrifai_tpu_torch trace FILE`` in a
                child beside the selector_options phase, whose summary
                must name workflow.train (an ``obs_cli`` line)
  4b. selector_options  the selector's options, four legs, a
                ``selector_options`` line each. Leg a: the default
                selector with strategy="halving" on the same 1M + 100k
                rows: the rungs (37 038 / 111 112 / 333 334 / 1 000 000
                rows, 26 / 9 / 3 / 1 candidates: SO_SCHEDULE, the JAX
                package's rung_schedule), each rung's wall and
                candidate-fold fits, launches against the growers'
                levels, holdout AuPR within SO_AUPR_GAP of the selector
                phase's; SO_CHECK_TREES forest trees grown on the rung-0
                rows of the checked matrix, every level bitwise to the
                plain version, the widest timed (a ``seg_hist`` line with
                ``path`` "halving"). Leg b, on SO_ROWS + SO_HOLDOUT rows
                of the same recipe: the default selector with a sweep
                checkpoint in a child (``--sweep-child``) killed by
                TMOG_FAULTS at the SO_KILL_AT-th save; the resume (units
                restored and refit), the uninterrupted sweep under
                TMOG_SYNC_SWEEP=1 (the same winner, fold metrics within
                SO_METRIC_TOL, bitwise or not), and another grid's
                checkpoint refused with the differing key. Leg c, on leg
                b's checked matrix (an LR grid and one forest, one fit a
                unit): one injected device loss (retries 1, quarantined
                0, the reference's metrics), a persistent one on the
                forest (it alone quarantined), both under a trace whose
                flight kinds must run fault.fired ->
                elastic.device_losses -> elastic.retries with every
                elastic event on a sweep.unit[i] span, the watchdog at
                SO_WATCHDOG_FACTOR over a CostModel fitted on leg b's
                group walls with an injected sleep of SO_SLOW_FACTOR
                deadlines (degraded, then ``failed: straggler``), and
                the tree-prep prefetch thread joined after a loss. Leg
                d: the Titanic demo with the default selector under
                with_workflow_cv() on SO_ROWS + SO_HOLDOUT rows
                (SanityChecker in the during-DAG, 26 fold-refit results)
                and a plain train of it: holdout AuPRs within
                SO_CV_AUPR_GAP, launches of both
  5. regression  the first 1/MODEL_DEPTH_CUT of the slice's rows and
                holdout (250k + 25k, cut from 1M + 100k to keep the
                smoke within its time limit): the same 500 Real columns
                plus one Integral column (30
                values, 5% missing) and one PickList (5 values, 5% null), a
                RealNN label from its own seed (22.5 + a linear part of
                variance 49 + 4 tanh(f10 f11) + the Integral and PickList
                effects + Gaussian noise of variance 9: the largest
                attainable R2 is printed), through the default regression
                selector: linear regression (4 x 2), random forests (3 x 2
                x 3, 50 trees, one-third feature subsets: d = 169 at the
                checked width of 508, bag mode "bagged") and GBT chains
                (depths 3, 6, 12 x 20 rounds, lockstep) under 3-fold CV,
                RMSE; the train's
                split by stage and by sweep group (binning, growth,
                scoring), every candidate's CV RMSE, the winner, holdout
                RMSE and R2 (must reach R2_FLOOR), trees grown, kernel
                launches against the growers' count, peak memory; save ->
                load on the card -> the holdout scored bitwise equal, the
                local scorer's rows equal to the loaded model's batch; then
                one OpGBTRegressor(max_depth=12, max_iter=20) fit on the
                checked matrix, which grows on GOSS row samples (ms per
                round, launches, holdout R2 against DEEP_R2_FLOOR); then
                the three regression tree paths grown on the checked
                matrix with every level's histograms held against the
                plain version (the tolerance below, its relative part of
                the per-bin sums of |channels|): 2 rounds of the GBT
                group's chains (depths 3, 6, 12), 2 rounds of the deep
                fit's GOSS chain and 2 trees of a regression forest
                (depth 12, one-third subsets)
  6. titanic    the reference's headline demo, examples/op_titanic_simple.py
                with this package's imports, on the first 1/TITANIC_DEPTH_CUT
                (250 000 + 25 000, cut from 1 000 000 + 100 000 to pay for
                the obs phase and the serving_plane phase) of the Titanic
                rows
                of examples/bench_pipeline.py's make_titanic_like recipe
                (``make_titanic``: no pandas) with the label redrawn from a
                logit of sex, class, fare and age: the train's split by
                stage (SmartText statistics, hashing and copy, the other
                vectorizers, the checker, the sweep), the sketch the tree
                prep took (must be ``sparse_aware``), the width before and
                after the checker and the forests' subset width, every
                candidate's CV AuPR, the winner, holdout AuPR against
                TITANIC_AUPR_SHARE x the attainable one (the true
                probabilities'), kernel launches against the growers'
                count, peak memory; TITANIC_CHECK_TREES demo forest trees
                grown on the checked matrix with every level held bitwise
                to the plain version and the widest level timed (a
                ``seg_hist`` line with ``path`` "titanic"); an ``efb``
                line on the checked matrix: the JAX rule's bundling plan
                (d -> d_b, bundles, members, or its decline and the width
                ratio), OpXGBoostClassifier(max_depth=EFB_DEPTH,
                num_round=EFB_ROUNDS) with TMOG_EFB at auto and 0 (ms a
                round, holdout AuPR within 1e-3, trees equal up to exact
                ties) and, where it bundles, a ``seg_hist`` line with
                ``path`` "efb" at the bundled width; save -> load
                (the holdout bitwise), the local scorer's rows, and
                TITANIC_SERVE_REQUESTS single rows with text through
                ModelServer (p50/p99, ``request_split``); a
                ``pivot_block`` line (``pivot_checks``): each OneHot and
                SmartText model's pivot block built on the card from its
                int32 indices on PIVOT_CHECK_ROWS holdout rows, bitwise
                against the host build of the same indices, both timed
  6b. validate_explain  the first 1/VE_DEPTH_CUT of the Titanic rows
                and holdout (125k + 12.5k, cut from 1M + 100k to keep
                the smoke within its time limit) with two
                planted raw features (seed VE_SEED): ``leak``, null exactly
                where Survived is 1, and ``rare``, filled on VE_RARE_SHARE
                of the rows; the demo trained with a RawFeatureFilter
                whose scoring data is the holdout with Fare scaled by
                VE_FARE_SCALE: the lint's wall and rule counts (none), the
                filter's seconds (numeric profiles on the card, text on
                the host), its drop list (must be exactly leak and rare,
                and no fitted stage may read them), each JS divergence
                (Fare's must stay below 0.9), the train's wall and stage
                seconds, holdout AuPR against the Titanic floor, the
                kernel's launches against the growers' levels;
                model_insights()'s JSON size and top 5 contributions;
                RecordInsightsLOCO on VE_LOCO_ROWS holdout rows (seconds,
                rows/s); RecordInsightsCorr, Pearson and Spearman, fitted
                and applied on the whole holdout; save -> load keeping
                rawFeatureFilterResults; then ``lint_refusals``: a label
                wired into a vectorizer (TM006) and an input no stage
                makes (TM001) raise PipelineLintError before any data is
                read; ``rff_numeric``: RawFeatureFilter over the slice's
                1M + 100k x 500 Real columns (seconds; VE_CHECK_COLS
                random columns' bins bitwise to the host numpy histogram;
                nothing dropped); ``spearman_loco``: the Spearman
                SanityChecker on the slice's 1M x 500 matrix (seconds, 50
                columns within 1e-5 of float64 numpy) and LOCO through the
                slice's boosted model on VE_XGB_LOCO_ROWS holdout rows
  6c. feature_eng  the first 1/FE_DEPTH_CUT of the Titanic rows
                and holdout (62.5k + 6.25k, cut from 1M + 100k to pay for
                the selector_options, refresh_cv and obs phases)
                with four more raw
                columns from FE_SEED (``feature_eng_columns``: Email with
                10% null and 5% malformed, EmailMap of it, Phone with US,
                +44, invalid and null values, Bio of 4-12 English, German
                and Spanish words or 2% Cyrillic or CJK text, Boarded over
                two years) through ``build_feature_eng``'s DAG: the name's
                tokens -> stop words -> bigrams -> FE_HASH_FEATURES hashed
                slots and -> Word2Vec (FE_W2V_SIZE), Bio's tokens -> a
                FE_VOCAB-term count vector -> LDA (FE_TOPICS), Age and Fare
                through DecisionTreeNumericBucketizer (the kernel at d = 1,
                5 channels, FE_DT_DEPTH levels), zscore, fill, percentile,
                the email, phone and language detectors, the day of week,
                the name/ticket Jaccard similarity and transmogrify, then
                VectorsCombiner -> MinVarianceFilter -> SanityChecker ->
                the default binary selector: the train's wall and
                stage_seconds, Word2Vec's pairs and steps, LDA's seconds,
                the widths before and after the filters, the bucket
                splits, every candidate's CV AuPR, holdout AuPR against
                FE_AUPR_SHARE x the attainable, the evaluator's full metric
                set, kernel launches against the growers' count plus the
                bucketizers' levels, peak memory; the bucketizers' splits
                through the kernel and the plain version on the same rows
                (equal), their d = 1 levels (and a K = 1 tree's, 3 float
                channels) held against the plain version (bitwise on
                integer channels) and timed (``seg_hist`` lines with
                ``path`` "dt_bucketizer_*": kernel, plain, library, bound);
                save -> load -> FE_ROUNDTRIP_ROWS holdout rows bitwise.
                Leg ``options`` (``build_fe_options`` on
                the first FE_OPTIONS_ROWS + FE_OPTIONS_HOLDOUT of the
                phase's rows (all of them where it has fewer)
                with map, geolocation, integral and set columns made from
                their own columns, ``fe_options_data``): every option of
                the feature-engineering stages off its default (the map
                vectorizers' allow_keys/block_keys, fill_with_mean=False,
                IntegralVectorizer(fill_with_mode=False, fill_value=
                FE_OPTIONS_FILL), SmartTextVectorizer(
                auto_detect_languages=True), SanityChecker(
                remove_feature_group=False)) trained on the card: the
                vector names only the allowed keys, the fills are the
                configured ones, save -> load -> score bitwise, and a
                ``pivot_block`` line (SmartText, MultiPickList, OneHot)
  6d. avro_combined  the reference's Avro ensemble demo
                (examples/op_titanic_avro_combined.py's ``build`` with the
                port's imports: ``build_avro_combined``): the Titanic
                recipe's first rows / AVRO_DEPTH_CUT and holdout /
                AVRO_DEPTH_CUT (62.5k + 6.25k, cut from 1M + 100k to pay
                for the selector_options phase, the out_of_core phase's
                leg d and the obs phase): their seven demo
                columns and label
                written by the port's write_avro (deflate) as two files
                (``avro_write_s``), read inside train() through
                OpWorkflow.set_reader(AvroReader(path)) (``avro_read_s``:
                decode and columns); transmogrify -> SanityChecker -> a
                linear selector (LR {0.01, 0.1}, MLP [8] x 200 steps of
                0.1) and a tree selector (50-tree forests at depths 6 and
                12) under 3-fold CV -> SelectedModelCombiner("weighted"):
                the train wall, each selector's sweep seconds and winner,
                the combiner's weights (checked against the weighted rule)
                and validation AuPRs, the holdout AuPR of each of the
                three predictions against AVRO_AUPR_SHARE x the attainable,
                seg_hist launches equal to the forests' levels, the
                demo's depth-12 forest levels on its checked matrix
                bitwise against the plain version (a ``seg_hist`` line
                with ``path`` "avro_combined"), peak memory, save -> load
                -> AVRO_ROUNDTRIP_ROWS holdout rows bitwise; then
                OpLinearSVC and OpNaiveBayes ``fit_raw`` on the slice's
                1M x 500 matrix (fit seconds, the SVC's Newton steps,
                holdout AuPR against SVC_AUPR_SHARE x the selector
                phase's and the base rate + NB_AUPR_MARGIN)
  6e. out_of_core  the Titanic recipe's rows (the smoke's rows and
                holdout divided by OOC_DEPTH_CUT: 500k + 50k) with
                validate_explain's two planted raw features written to
                CSV with the ``csv`` module (seconds, bytes). Leg a:
                examples/bench_ingest.py's DAG (the ten predictors ->
                transmogrify -> SanityChecker(max_correlation=0.99) ->
                OpNaiveBayes) on the first 1/OOC_A_ROWS_CUT of those
                training rows (250k) trained in-core and with
                train(chunk_rows=OOC_CHUNK_ROWS), each in a child process
                of its own (``--ooc-child``): wall, peak RSS sampled from
                /proc/self/statm and its delta over the post-import
                baseline, peak device memory, the chunked passes (rows/s,
                bytes, parse and transform seconds, overlap efficiency),
                spilled MB; vocabularies and keep lists equal, fills
                within OOC_FILL_RTOL, naive Bayes within OOC_NB_TOL,
                holdout AuPRs within OOC_AUPR_GAP and above the base rate
                + OOC_NB_AUPR_MARGIN, the chunked RSS delta below the
                in-core one, every estimator streamed. Leg b: a
                RawFeatureFilter, the same predictors and the planted
                ones, SanityChecker() and the default binary selector,
                train(chunk_rows=OOC_SELECTOR_CHUNK_ROWS) and in-core in
                this process: the filter's pass, each pass's and the
                tail's seconds, peak device memory; drops exactly leak and
                rare, the same checked columns and winner, AuPRs within
                OOC_AUPR_GAP and above OOC_AUPR_SHARE x the attainable,
                only the selector fitted in-core, launches equal to its
                forests' levels, and the path's forest shape (d = 23
                subsets, depth 12) grown on the streamed matrix bitwise
                against the plain version (a ``seg_hist`` line with
                ``path`` "out_of_core"). Leg c: the chunked model saved,
                loaded and served with a DriftMonitor: OOC_DRIFT_ROWS
                clean holdout rows in one request drift on nothing, the
                next ones with Fare x 3 and Sex flipped on Fare and Sex;
                batch-1 p50/p99 with and without the monitor. Leg d
                (kill and resume): the first OOC_CKPT_ROWS train rows and
                OOC_CKPT_HOLDOUT holdout rows; leg b's DAG trained with
                train(chunk_rows=OOC_CKPT_CHUNK_ROWS, checkpoint_dir=,
                checkpoint_every_chunks=OOC_CKPT_EVERY): uninterrupted,
                then in a child (``--ckpt-child``) that TMOG_FAULTS kills
                at checkpoint save OOC_CKPT_KILL_AT inside the first fit
                pass, then resumed here from the child's directory (after
                another chunk_rows is refused against it with
                CheckpointMismatchError naming ``chunkRows``): each wall,
                the saves and their seconds, the resume's
                ``chunks_skipped``; vocabularies, the filter's drop list
                and the checker's keep list equal, holdout probabilities
                within OOC_CKPT_PROBA_TOL (bitwise said), the checkpoint
                directories gone after success, launches of both trains
  6e'. refresh_cv  in the out_of_core phase's process, after its leg d,
                on leg d's rows and holdout, leg b's DAG with the filter.
                Leg a: RCV_CV_ROWS rows under with_workflow_cv(), chunked
                (RCV_CHUNK_ROWS: the streaming workflow CV) and in core:
                each wall and launches; the fold ids the chunked train
                assigned equal the in-core validator's, the same winner,
                every fold metric within SanityChecker's
                streaming_fit_tol, holdout AuPRs within SO_CV_AUPR_GAP.
                Leg b: the first RCV_BASE_ROWS rows trained chunked,
                saved and loaded (its fit_states equal), refreshed twice
                with the rest of leg d's rows: the refresh report and
                walls; every merged state within RCV_STATE_RTOL of leg
                d's uninterrupted train's (the chunk boundaries
                coincide), the second refresh's probabilities bitwise.
                Leg c: RCV_TUNER_ROWS rows with
                train(tuner=Tuner(strategy="halving", auto_plan=True,
                host_budget_bytes=RCV_TUNER_BUDGET), profile=True): the
                advice (streamed with its chunk rows), the profiler's top
                stages, the profiled launches equal to the counter's, the
                selector's strategy restored; then in-core trains with
                TMOG_PLAN_WORKERS=1 and with the default pool, walls and
                probabilities bitwise equal (an LR grid in the selector's
                place: the pool runs host stages). Each wall beside
                REFRESH_CV_PREDICTED
  6f. events    event-time AutoML: examples/bench_events.py's JSONL
                clickstream (``make_clickstream``, drawn vectorised) of
                EV_USERS users (~400 000 events, ~100 MB) and a holdout
                log of EV_HOLD_USERS; the events DAG (``build_events``:
                n_events, total_dwell, n_checkout, pages_seen ->
                transmogrify -> SanityChecker -> the default binary
                selector; purchased the response). Leg a: the record log
                parsed whole into a ConditionalDataReader and trained
                in-core, and StreamingConditionalReader(JSONLinesReader)
                with train(chunk_rows=EV_CHUNK_ROWS), each in a child
                (``--events-child``, warmed by a train on a small log
                before its RSS baseline): wall, each pass's rows/s, rows,
                RSS delta, peak device memory; rows and keys equal, the
                same winner, holdout probabilities within EV_PROBA_TOL,
                holdout AuROC at least EV_AUROC_FLOOR, the streamed RSS
                delta below EV_RSS_RATIO x the in-core one, launches equal
                to the forests' levels; the streamed model's checked
                matrix grown as the forests grow it, every level bitwise
                (a ``seg_hist`` line with ``path`` "events"). Leg b, on
                EV_B_USERS users with an LR grid, chunked: a log with
                EV_BAD_LINES invalid lines under the quarantine policy
                (each quarantined once over the passes, the sidecar and
                the rows reconciled), an IO error injected at
                ``event.window`` under a RetryPolicy (one retry, the clean
                run's scores), train() refusing a reader with no cutoff
                (TM060), and DriftMonitor quiet on a fresh log and fired
                on 3x the event rate; a ``pivot_block`` line (the
                MultiPickList of pages_seen)
  6g. app       APP_ROWS Titanic rows with a PassengerId written to CSV;
                ``python -m transmogrifai_tpu_torch gen Titanic`` in a
                child; the generated App in this process: --run-type
                train (the default selector, 3-fold CV) and evaluate
                (which writes its scores); the generated run.py's score
                in a child, its scores equal to the evaluate run's within
                APP_SCORE_TOL; the metrics JSON with the JAX runner's
                keys; the train's launches
  7. multiclass  the regression phase's rows (250k + 25k: the slice's
                divided by MODEL_DEPTH_CUT) of the same 500 Real columns
                with a K = 5 label from its
                own seed (class logits: log priors 0.40 / 0.25 / 0.15 /
                0.12 / 0.08, a linear part of standard deviation
                MC_LINEAR_SD in MC_GROUP_COLS columns of the class's
                own, one tanh
                interaction; Gumbel noise; the label their argmax: the
                attainable holdout F1, that of the true probabilities'
                argmax, is printed) through the default multiclass
                selector: softmax LR (4 x 2, one Böhning-bound solve) and
                K-class forests (3 x 2 x 3, 50 trees, d = 22 subset
                columns, 5 channels a level) under 3 stratified folds,
                F1, DataCutter; the train's split by stage and sweep
                group, every candidate's CV F1, the winner, holdout F1,
                Accuracy and LogLoss against MC_F1_SHARE x the attainable,
                kernel launches against the growers' count, peak memory;
                MC_CHECK_TREES forest trees on the checked matrix with
                every level held bitwise to the plain version (a
                ``seg_hist`` line with ``path`` "multiclass"); save ->
                load (bitwise), the local scorer and MC_SERVE_REQUESTS
                single rows through ModelServer (within 1e-6)
  8. boosted_multi  the general tree grower on the multiclass phase's
                datasets: the multiclass selector over a softmax XGBoost
                grid (max_depth 4, 6 x BOOSTED_SELECTOR_ROUNDS rounds, eta
                0.3) and a decision-tree grid (max_depth 6, 10, min
                instances 10), 3 stratified folds, F1, every candidate a
                sequential fit: the train's split by stage, every
                candidate's CV F1, the winner (must be the softmax
                XGBoost), holdout F1 against BOOSTED_F1_SHARE x the
                attainable, ``sequential_fits`` with the binnings each
                built and ``tree_binnings`` (the sweep memo's binnings
                and hits: one binning of the checked matrix serves all 13
                fits), the train's wall beside BOOSTED_TRAIN_S_EARLIER
                (before the memo), kernel launches against the growers'
                count, save -> load (bitwise), the local scorer and
                MC_SERVE_REQUESTS single rows; ``xgb_defaults``
                (one OpXGBoostClassifier(num_class=5) fit at the
                reference's defaults: 200 rounds, depth 10, eta 0.02, gamma
                0.8, early stopping after 20: rounds grown and kept, ms per
                round, holdout F1 and LogLoss); ``count_and_subsample``
                (OpGBTClassifier with min instances 10 and min info gain
                0.001, and OpXGBoostClassifier with subsample 0.8 and
                colsample_bytree 0.5, both depth 6 x BOOSTED_BINARY_ROUNDS
                on the slice's binary label: ms per round, holdout AuPR
                against BOOSTED_AUPR_FLOOR); ``levels_vs_plain``: 3 rounds
                of a 5-class softmax fit (11 float channels) and of each
                binary fit (3 float channels) within the tolerance of
                |channels|, and one depth-10 5-class decision tree (11
                integer channels) bitwise; ``seg_hist`` lines with ``path``
                "dt_multi" (that tree's widest level), "gbdt_multi" (11
                float channels at the checked width, M = 1, 32, 512) and
                "gbdt_count" (3 float channels, M = 1, 32)
 9. glm_isotonic  a poisson OpGeneralizedLinearRegression (IRLS) on the
                slice's 1M x 500 columns with a count label drawn from a
                log-linear rate of its own seed (GLM_SEED): seconds, IRLS
                steps, holdout deviance against GLM_DEVIANCE_RATIO x the
                true rate's and below the intercept-only model's; an
                IsotonicRegressionCalibrator on the slice's boosted
                model's holdout scores: seconds, blocks, monotonicity,
                calibrated AuPR within ISO_AUPR_GAP of the raw one
 10. xgb_wide  BASELINE.md config 5: examples/bench_xgb_wide.py's
                make_sparse_data recipe (seed 17, 5% density, 2000
                columns; the smoke's rows and holdout divided by
                WIDE_DEPTH_CUT, 137 500 rows made in one call, the first
                125k to train, the last 12 500 held out: cut from 1M +
                100k, then from 250k + 25k for the serving_plane phase,
                to keep the smoke within its time limit), one
                OpXGBoostClassifier
                at the reference's defaults (200 rounds, eta 0.02, depth
                10, gamma 0.8, early stopping 20, seed 13) through fit_raw:
                data_s, the sketch (must be ``sparse_aware``), the EFB
                decision (the fit's, and the widest plan's width ratio),
                GOSS's (k_top, k_rest), binning and boosting seconds,
                rounds grown and kept, ms per round, train and holdout
                AuPR against WIDE_AUPR_SHARE x the attainable (the
                noiseless score's), launches against the grower's levels,
                peak memory; the CSR leg: the CSR's build seconds and
                nz_max, two depth-6 fits of 40 rounds with and without
                TMOG_SPARSE_HIST=1 (ms a round, the share of levels each
                took through the CSR, trees equal up to exact ties,
                holdout AuPR within 1e-3), 2 rounds of each leg's levels
                held against the plain version; ``seg_hist`` lines with
                ``path`` "xgb_wide" (d = 2000, M = 1, 32, 512 on 125k rows,
                and M = 32 on one GOSS sample)
 11. iris      the reference's Iris demo (examples/op_iris_simple.py's
                DAG and grid: LR {0.01, 0.1}, MLP [5, 4] and [10], a
                stratified train/validation split) on 1M + 100k rows of an
                Iris-shaped frame (the reference CSV's class means and
                standard deviations, three balanced classes, seed 13):
                the kept labels, both families' validation F1, the winner,
                the MLP fits' steps and seconds, holdout F1 against
                IRIS_F1_SHARE x the attainable (the Gaussian Bayes rule's)
  12. serve     both trained models (the slice's boosted model, the
                selector's winner): save (seconds, bytes) and load on the
                card (seconds); the holdout scored after the round trip
                bitwise equal to the in-memory model; CSV_ROWS (1k) holdout rows
                written as CSV (floats by repr) and read back by CSVReader
                scoring equal to the in-memory model; single-row
                requests through score_function_batch split by stage
                (its per-stage hook, synchronised);
                ModelServer.from_path(max_batch=64): SEQ_REQUESTS (100)
                sequential single-row requests (p50/p99), a burst of
                BURST_REQUESTS (512) single rows from 8 threads (rows/s,
                mean batch, padded share), BIG_REQUESTS (25) requests of
                64 rows (p50/p99), served scores within 1e-6
                of the in-memory model's (and the bitwise share), no shed,
                device error or host fallback; OBS_SERVE_REQUESTS (20)
                single rows under a trace, whose serve.admit >
                serve.batch > serve.execute spans must nest across the
                dispatch thread, and the Prometheus text of a snapshot
                parsed back to its request count; /score, /healthz,
                /metrics and /metrics?format=prometheus (the same
                request count) over HTTP on 127.0.0.1; and the committed
                tests/fixtures/model_v1 scored on the card within 1e-5 of
                its expected scores.  The phase must launch no kernel
                (scoring is plain torch on the card)
 12b. serving_plane  the rest of one host's serving plane at the slice's
                width, on the first 1/MODEL_DEPTH_CUT training rows and
                the holdout's rows (with their label): (a) an
                OpLogisticRegression alone on the 500 columns, saved and
                served twice with max_batch=64, eagerly and with
                device_programs=True (a CUDA graph per bucket, each
                exported into a fresh AOTStore under smoke_out/):
                SP_SEQ_REQUESTS (100) single rows and SP_BIG_REQUESTS
                (20) 64-row requests each (p50/p99), every bucket "jit",
                the graph-served scores bitwise equal to the eager
                server's (else within 1e-6, written down), no compile
                after warm-up and one hit and one replay a batch, each
                bucket's export and capture seconds; a fresh replica in a
                child (``--aot-child DIR``) over the same store: every
                bucket "aot", no compile, its scores bitwise the parent's,
                its cold start to the first score; model_v1 with graphs
                within 1e-5 of its expected scores; (b) the host rung on
                the graph server and on the slice's boosted model: the
                executor's scoring made to raise, SP_HOST_REQUESTS single
                rows and SP_HOST_BIG_REQUESTS 64-row requests answered by
                the model's CPU copy within SP_HOST_TOL (1e-5) of the
                card's, hostFallbacks counted, lastFallbackReason
                "device_error:RuntimeError", the breaker open, /healthz
                degraded, then a trial batch after SP_BREAKER_RESET_S
                closing the breaker on the card; (c) the boosted model
                served with a GuardedSwap (SP_REPLAY_ROWS live rows in
                the replay window; the label's metric gate): (i) a
                candidate retrained on the card (seed SP_CANDIDATE_SEED,
                seg_hist launches) accepted, the outgoing generation
                pinned and a clean bake keeping it, (ii) the LR with its
                coefficients negated rejected by the prediction gate,
                (iii) an accepted candidate rolled back to the pinned
                generation by a swap.bake fault; shadow and bake seconds;
                (d) a MultiTenantServer of gold (the boosted model, weight
                3) and bronze (the LR, weight 1): routed scores within
                1e-6 of each model's own server, a SP_FLOOD_S (1.5 s)
                flood from SP_FLOOD_THREADS (8) threads at quotas of
                SP_TENANT_QUEUE_ROWS (64): dispatched rows gold/bronze
                within SP_WFQ_RATIO, only the flooding tenant shedding
                when bronze alone floods, a device fault on bronze falling
                back on bronze only, the per-tenant Prometheus text and
                /tenants over HTTP.  Every clean server ends with no host
                fallback, device error or shed
 13. seg_hist  kernel vs plain at the slice's level shapes (N=1M, d=500,
                B=32, nchan=2, M=1..32, a level with empty slots), the level
                shapes of depths 7 and 10 (M=64, 512), d=497 through
                apply_bins' padded rows, one level of unpadded rows (the
                4-byte row copies) and the forests' level shapes (d=22 in
                32-byte rows, Poisson-count channels, M=1..2048, bitwise
                equal to plain), and at the regression phase's checked
                width (508 at full size) the regression forests' levels
                (d = 508 // 3 = 169 in 176-byte rows, float channels (bw y,
                bw), M = 1, 64, 512, 2048) and the GBT chains' depth-12
                levels (d = 508, float channels (w (F - y), w), M = 1024,
                2048): error within
                tolerance, determinism, kernel/plain/library/bound ms, the
                layout's share, the groups and reduce passes' device ms and
                the shared-memory floor
 14. seg_hist_channels  the kernel at C channels: K-class forest levels
                (d = 22, integer channels) at C = 3, 5, 10, 13, 14, 100
                and M = 1, 64 (one launch up to 13 channels at 32 bins,
                one per channel group past it), bitwise equal to plain,
                and a softmax objective's float level (C = 10, d = 500, M
                = 32) within tolerance: ms, plain, library, bound,
                shared-memory floor and the groups launched; then a
                ``seg_hist_two_channel`` line beside the two-channel
                kernel's earlier numbers
 15. profile   an 8-round fit at the same width under torch.profiler:
                binning and boosting walls, the card's busy time and idle
                share, the boosting's heaviest device ops per round
 16. regression_profile  one forest of 4 regression trees (depth 12,
                one-third subsets) and one boosted chain's 3 rounds (depth
                12, full width) under torch.profiler: wall, the card's busy
                time and idle share per level, the heaviest device ops
 17. serve_profile  single-row requests of both loaded models under
                torch.profiler: the card's busy time and idle share, the
                device ops and copies a request
The phases that run torch.profiler come after the slice and the selector,
so no profiler session runs in the process before their walls are taken.
Then the ``kernels`` summary line (``launches``: the slice's, the
selector's, the selector_options phase's trains and sweeps, the
regression phase's, the titanic phase's (its efb fits
too), the validate_explain, feature_eng and avro_combined phases'
trains, the out_of_core phase's chunked selector train and leg d's two
trains (the killed child stops before its selector), the events
phase's two leg-a trains, the app phase's train, the
multiclass phase's, the
boosted_multi phase's train, xgb_defaults and count_and_subsample fits,
the xgb_wide phase's three fits and the serving_plane phase's retrained
candidate), the card's name and power limit,
and the result line.  Any
failed check exits non-zero.  Without a CUDA device the script exits with
code 1 and prints no result.

Usage: python3 chip_smoke.py [--rows N] [--holdout N] [--cols D]
                             [--rounds R] [--reps K]
"""
import argparse
import csv
import faulthandler
import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np
import torch

from transmogrifai_tpu_torch.analysis import PipelineLintError
from transmogrifai_tpu_torch.cuda_build import build
from transmogrifai_tpu_torch.device import resolve_device
from transmogrifai_tpu_torch.evaluators.evaluators import Evaluators
from transmogrifai_tpu_torch.evaluators.metrics import (aupr,
                                                        multiclass_metrics)
from transmogrifai_tpu_torch.features.builder import FeatureBuilder
from transmogrifai_tpu_torch.features.feature import Feature
from transmogrifai_tpu_torch.filters import RawFeatureFilter
from transmogrifai_tpu_torch.insights import (RecordInsightsCorr,
                                              RecordInsightsLOCO,
                                              parse_insights)
from transmogrifai_tpu_torch.local import score_function_batch
from transmogrifai_tpu_torch.models import gbdt_kernels as gk
from transmogrifai_tpu_torch.models.classification import (
    OpLinearSVC, OpLogisticRegression, OpNaiveBayes)
from transmogrifai_tpu_torch.models.mlp import \
    OpMultilayerPerceptronClassifier
from transmogrifai_tpu_torch.models.regression import (
    IsotonicRegressionCalibrator, OpGeneralizedLinearRegression)
from transmogrifai_tpu_torch.models.trees import (MEMO_STATS, SKETCH_KINDS,
                                                  OpDecisionTreeClassifier,
                                                  OpGBTClassifier,
                                                  OpGBTRegressor,
                                                  OpRandomForestClassifier,
                                                  OpXGBoostClassifier,
                                                  binned_for_edges,
                                                  boost_chains,
                                                  maybe_bundle,
                                                  prep_tree_csr,
                                                  prep_tree_inputs)
from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
from transmogrifai_tpu_torch.ops.vectorizers import (
    MultiPickListVectorizerModel, OneHotVectorizerModel, RealVectorizer,
    SmartTextVectorizer, SmartTextVectorizerModel, pivot_block,
    pivot_block_host)
from transmogrifai_tpu_torch.preparators.sanity_checker import SanityChecker
from transmogrifai_tpu_torch.readers.avro import AvroReader, write_avro
from transmogrifai_tpu_torch.readers.files import CSVReader
from transmogrifai_tpu_torch.selector.combiner import SelectedModelCombiner
from transmogrifai_tpu_torch.selector.model_selector import (
    BinaryClassificationModelSelector, ModelSelector,
    MultiClassificationModelSelector, RegressionModelSelector, grid)
from transmogrifai_tpu_torch.selector.validators import (OpCrossValidation,
                                                         make_folds)
from transmogrifai_tpu_torch.serving import (AOTStore, GuardedSwap,
                                             ModelServer, MultiTenantServer,
                                             SwapGateConfig, TenantConfig)
from transmogrifai_tpu_torch.serving.aot import find_predictor
from transmogrifai_tpu_torch.stages.base import Estimator
from transmogrifai_tpu_torch.serving.http import healthz_doc, make_http_server
from transmogrifai_tpu_torch.types import feature_types as ft
from transmogrifai_tpu_torch.tuning.halving import (HalvingConfig,
                                                    nested_subsample_order)
from transmogrifai_tpu_torch.types.columns import ColumnarDataset, FeatureColumn
from transmogrifai_tpu_torch import obs
from transmogrifai_tpu_torch.utils import compile_cache, faults
from transmogrifai_tpu_torch.utils import profiling as tprof
from transmogrifai_tpu_torch.utils.profiling import (MetricsCollector,
                                                     install_collector)
from transmogrifai_tpu_torch.utils.streaming_histogram import \
    StreamingHistogram
from transmogrifai_tpu_torch.workflow.dag import compute_dag, transform_dag
from transmogrifai_tpu_torch.workflow.workflow import (OpWorkflow,
                                                       OpWorkflowModel)

#: kernel vs plain tolerance: float32 sums taken in another order
RTOL, ATOL = 1e-5, 1e-4
#: the card the port is built for and its published peaks (NVIDIA's data
#: sheet, SXM part): device memory bytes/s, float32 (non-tensor-core) ops/s
CARD = "NVIDIA H100 80GB HBM3"
PEAK_BYTES_PER_S, PEAK_F32_OPS_PER_S = 3.35e12, 67e12
SEG_HIST_SOURCE = "transmogrifai_tpu_torch/csrc/seg_hist.cu"
SEG_HIST_REPLACES = "transmogrifai_tpu/models/gbdt_kernels.py:638"
FULL_ROUNDS = 200
REPO = os.path.dirname(os.path.abspath(__file__))
#: the serve phase's traffic: holdout rows through CSV, sequential
#: single-row requests, a burst of single rows from several threads,
#: 64-row requests, rows over HTTP
# the serve phase's depth, cut (from 500, 4096, 200 and 20 profiled
# requests, and from 10k CSV rows, then 5k to pay for the obs phase; then
# from 200, 1024 and 50 requests and 2 500 CSV rows to pay for the
# serving_plane phase) to keep the smoke within its time limit
CSV_ROWS, SEQ_REQUESTS, BURST_REQUESTS, BURST_THREADS = 1_000, 100, 512, 8
BIG_REQUESTS, HTTP_ROWS, SPLIT_REQUESTS = 25, 4, 20
PROFILE_REQUESTS = 5
#: the serving_plane phase (12b): single-row and 64-row requests each
#: server answers; the single rows the fresh replica answers beside one
#: 64-row request; the host rung's requests (single, 64-row) and its
#: tolerance against the card (float32 sums on the CPU in another order);
#: the breaker's reset; the guard's replay window (live 64-row requests);
#: the retrained candidate's seed, the latency gate's factor (a p99 of 16
#: shadow batches is their slowest, and one host stall has reached 8.5x
#: the other model's on the card's host: it must not reject a candidate
#: of the live model's family); each tenant's quota and largest batch (a quarter
#: of the quota, so that a dispatch leaves its lane non-empty under a
#: flood), the flood's seconds, threads and rows a request (enough that
#: threads sharing the interpreter lock keep both lanes full) and the
#: dispatched-rows ratio gold/bronze it must reach (weights 3:1)
SP_SEQ_REQUESTS, SP_BIG_REQUESTS, SP_REPLICA_SINGLES = 50, 10, 8
SP_HOST_REQUESTS, SP_HOST_BIG_REQUESTS, SP_HOST_TOL = 10, 4, 1e-5
SP_BREAKER_RESET_S, SP_REPLAY_ROWS, SP_CANDIDATE_SEED = 1.5, 256, 7
SP_P99_FACTOR = 100.0
SP_TENANT_QUEUE_ROWS, SP_TENANT_MAX_BATCH = 64, 16
SP_FLOOD_S, SP_FLOOD_THREADS, SP_FLOOD_ROWS = 1.5, 8, 8
SP_WFQ_RATIO = (2.0, 4.5)
#: the phase as predicted before its first run on the card (PERF.md
#: section 6), for a host like the previous final proof run's: its
#: seconds, the fresh replica's cold start (the server's construction to
#: its first score, in the child) and its process wall, the graph
#: server's batch-1 p50
SERVING_PLANE_PREDICTED = {"phase_s": [40.0, 80.0],
                           "replica_cold_start_s": [1.0, 5.0],
                           "replica_process_s": [8.0, 20.0],
                           "graphs_batch1_p50_ms": [3.0, 9.0]}
#: boosting rounds of the profiled fit (one early-stopping chunk)
PROFILE_ROUNDS = 8
#: the regression phase's label: its seed, the variance of its linear
#: part and of its Gaussian noise; the holdout R2 it must reach (stated
#: before the first chip run, below the largest attainable R2 of about
#: 0.87 that the noise share leaves, and above the linear part's share)
REG_SEED, REG_LINEAR_VAR, REG_NOISE_VAR = 5, 49.0, 9.0
R2_FLOOR = 0.75
#: the direct deep GBT fit of the regression phase, and the holdout R2
#: it must reach (stated before its first chip run: the depth-12 GBT
#: candidate's CV RMSE of 4.30 gives R2 near 0.72 at the label's variance
#: of about 65; a grower that picks wrong splits falls far below)
DEEP_DEPTH, DEEP_ROUNDS = 12, 20
DEEP_R2_FLOOR = 0.65
#: rounds and trees of the regression tree paths grown at full size with
#: every level's histograms held against the plain version
CHECK_ROUNDS, CHECK_TREES = 2, 2
#: the titanic phase: the seed of its label's uniform draws; the share of
#: the attainable holdout AuPR (that of the true probabilities) the
#: trained demo must reach (stated before the first chip run); the
#: single-row requests it serves (200 before the serving_plane phase)
TITANIC_LABEL_SEED = 11
TITANIC_AUPR_SHARE = 0.9
TITANIC_SERVE_REQUESTS = 100
#: demo forest trees grown on the checked matrix with every level held
#: bitwise to the plain version: the demo's whole forest on one fold, so
#: the check meets the deepest levels its trees reach
TITANIC_CHECK_TREES = 50
#: the multiclass phase's label: its seed, its classes and their priors;
#: the share of the attainable holdout F1 (that of the argmax of the true
#: class probabilities) the trained selector must reach (stated before the
#: first chip run); the forest trees grown on the checked matrix with
#: every level held bitwise to the plain version; single rows served
MC_SEED, MC_CLASSES = 17, 5
MC_PRIORS = (0.40, 0.25, 0.15, 0.12, 0.08)
#: each class's linear part: its standard deviation (the Gumbel noise's
#: is 1.28) and the columns of its own group it spreads over.  At 2 and
#: 20 columns the attainable F1 is near 0.66 and a forest's 22-column
#: subset holds ~4 informative columns; the first runs' (1, 4) and (2, 4)
#: left most subsets without one, and the forests barely split
MC_LINEAR_SD, MC_GROUP_COLS = 2.0, 20
MC_F1_SHARE = 0.9
MC_CHECK_TREES = 10
#: single rows the multiclass phase serves (200 before the serving_plane
#: phase)
MC_SERVE_REQUESTS = 100
#: the iris phase: the frame's seed and the share of the attainable
#: holdout F1 (the Bayes argmax of the classes' Gaussian densities) the
#: demo must reach (stated before the first chip run)
IRIS_SEED = 13
IRIS_F1_SHARE = 0.9
#: per Iris class (setosa, versicolor, virginica): the reference CSV's
#: class means and standard deviations of sepal length, sepal width,
#: petal length and petal width
IRIS_COLS = ("sepalLength", "sepalWidth", "petalLength", "petalWidth")
IRIS_MEANS = np.array([[5.006, 3.428, 1.462, 0.246],
                       [5.936, 2.770, 4.260, 1.326],
                       [6.588, 2.974, 5.552, 2.026]])
IRIS_SDS = np.array([[0.352, 0.379, 0.174, 0.105],
                     [0.516, 0.314, 0.470, 0.198],
                     [0.636, 0.322, 0.552, 0.275]])
#: the boosted_multi phase: the XGBoost grid's rounds in the multiclass
#: selector (the reference's 200 cut to keep the phase near 100 s of the
#: card's time; eta 0.3 in place of 0.02 so 30 rounds reach a fitted
#: model), the rounds of its count-gated and subsampled binary fits, the
#: rounds grown with every level held against the plain version; the
#: share of the attainable holdout F1 the selector's
#: winner must reach and the holdout AuPR both binary fits must reach
#: (stated before the first chip run; the slice's AuPR is 0.94)
BOOSTED_SELECTOR_ROUNDS, BOOSTED_BINARY_ROUNDS = 30, 20
BOOSTED_CHECK_ROUNDS = 3
BOOSTED_F1_SHARE, BOOSTED_AUPR_FLOOR = 0.8, 0.85
#: the boosted_multi train's wall before the sweep memo, reprinted beside
#: this run's (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md)
BOOSTED_TRAIN_S_EARLIER = 33.54
#: the seg_hist phase's channel sweep: K-class forest levels (d = 22,
#: integer channels) at these channel counts and slot counts, and one
#: float-channel level of a 5-class softmax objective (2K = 10 channels
#: at d = 500, M = 32); the two-channel kernel's ms measured before it
#: took any channel count (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md),
#: reprinted beside this run's
SWEEP_CHANNELS, SWEEP_SLOTS = (3, 5, 10, 13, 14, 100), (1, 64)
EARLIER_XGB_MS, EARLIER_RF_MS = (0.525, 0.528), (0.22, 0.30)
#: the xgb_wide phase, BASELINE.md config 5 (examples/bench_xgb_wide.py),
#: on --rows + --holdout rows (1M + 100 000 by default): its columns,
#: density and data seed; the share of
#: the attainable AuPR (the noiseless score's) its fit must reach on the
#: train and the held-out rows (stated in PERF.md before the first full
#: run); the CSR leg's two fits (depth below GOSS's gate) and the rounds
#: whose every level is held against the plain version
WIDE_COLS, WIDE_DENSITY, WIDE_SEED = 2000, 0.05, 17
WIDE_AUPR_SHARE = 0.85
WIDE_CSR_DEPTH, WIDE_CSR_ROUNDS, WIDE_CHECK_ROUNDS = 6, 40, 2
#: the CSR leg's trees must first part where the two cuts' float64 gains
#: lie within this relative gap (a tie within float32 rounding)
WIDE_TIE_GAP = 1e-5
#: the efb line's fits on the Titanic demo's checked matrix (bundled and
#: not): their depth and rounds
EFB_DEPTH, EFB_ROUNDS = 6, 40
#: the glm_isotonic phase: the seed of its count label, the columns of
#: its log-linear rate and their coefficients' scale, the intercept; the
#: holdout deviance it must reach, as a multiple of the true rate's
#: (stated before the first chip run)
GLM_SEED, GLM_INFORMATIVE, GLM_COEF_SD, GLM_INTERCEPT = 23, 20, 0.2, 0.5
GLM_DEVIANCE_RATIO = 1.02
#: how far the calibrated holdout AuPR may sit from the raw one: a
#: monotone map keeps the order but flat steps make ties
ISO_AUPR_GAP = 0.01
#: validate_explain: the planted features' seed, ``rare``'s fill rate
#: (below RawFeatureFilter's min_fill_rate of 0.001), the scoring data's
#: Fare scale, LOCO's rows on the demo and on the slice's boosted model,
#: the columns held to the host histogram and to numpy's Spearman, and the
#: columns stacked a copy to the card
VE_SEED = 29
VE_RARE_SHARE = 0.0005
VE_FARE_SCALE = 1.5
VE_LOCO_ROWS, VE_XGB_LOCO_ROWS = 10_000, 2_000
VE_CHECK_COLS, VE_SPEARMAN_CHECK, VE_STACK_COLS = 20, 50, 50
#: host threads of those checks (numpy's sorts release the GIL)
VE_HOST_THREADS = 8
#: the feature_eng phase: the seed of its four extra raw columns; the
#: widths of its text stages (hashed name bigrams, Word2Vec vectors, the
#: Bio vocabulary and its LDA topics); the share of the attainable holdout
#: AuPR (the true probabilities') its selector must reach, stated before
#: its first chip run (the titanic phase's share: the extra columns carry
#: no signal, the stages must not lose the demo's); the rows scored after
#: the save/load round trip; the tree bucketizers' depth and bins (the
#: JAX package's defaults) and their information-gain gate (a hundredth
#: of the default 0.01: at 100 000 rows of this label Age's and Fare's
#: best splits gain less than 0.01 a row, and at 0.001 Age keeps one)
FE_SEED = 31
FE_HASH_FEATURES, FE_W2V_SIZE, FE_VOCAB, FE_TOPICS = 512, 50, 256, 10
FE_AUPR_SHARE = 0.9
FE_ROUNDTRIP_ROWS = 1000
FE_DT_DEPTH, FE_DT_BINS, FE_DT_MIN_GAIN = 4, 32, 1e-4
#: Bio's words: English, German and Spanish stop words (LangDetector's
#: profiles) and content words; 2% of the rows are Cyrillic or CJK text
FE_BIO_WORDS = (
    "the and of to in is that it was for on are with as his they at one "
    "have this from der die das und ist von zu den nicht mit sich auf "
    "el la los las de y un una del en es que no se por con para "
    "travel ocean ship cabin deck harbor journey family captain storm "
    "letter music garden winter summer city river mountain history "
    "reise schiff meer stadt familie viaje barco mar ciudad familia").split()
FE_OTHER_SCRIPTS = ("Привет как дела", "путешествие по морю", "東京から大阪へ",
                    "海の旅", "家族と一緒に", "Москва и река")
#: the avro_combined phase: the Avro schema of the seven columns the
#: reference's Avro demo reads and its label; the share of the attainable
#: holdout AuPR each of its three predictions must reach (the titanic
#: phase's share, stated before its first chip run); the rows scored
#: after the save/load round trip; the linear SVC's share of the default
#: selector's holdout AuPR on the slice's label, and naive Bayes's margin
#: over the label's base rate (its clipped matrix drops the negative half
#: of every Gaussian column), both stated before their first chip run
AVRO_SCHEMA = {"type": "record", "name": "Passenger", "fields": [
    {"name": "Survived", "type": "double"},
    {"name": "Pclass", "type": ["null", "string"]},
    {"name": "Sex", "type": ["null", "string"]},
    {"name": "Age", "type": ["null", "double"]},
    {"name": "SibSp", "type": ["null", "long"]},
    {"name": "Parch", "type": ["null", "long"]},
    {"name": "Fare", "type": ["null", "double"]},
    {"name": "Embarked", "type": ["null", "string"]}]}
AVRO_AUPR_SHARE = 0.9
AVRO_ROUNDTRIP_ROWS = 1000
SVC_AUPR_SHARE, NB_AUPR_MARGIN = 0.95, 0.3
# the out_of_core phase (6e): examples/bench_ingest.py's predictors, its
# chunk_rows, and leg b's chunks
OOC_PREDICTORS = (("PickList", "Pclass"), ("Text", "Name"),
                  ("PickList", "Sex"), ("Real", "Age"), ("Integral", "SibSp"),
                  ("Integral", "Parch"), ("PickList", "Ticket"),
                  ("Real", "Fare"), ("PickList", "Cabin"),
                  ("PickList", "Embarked"))
OOC_CHUNK_ROWS, OOC_SELECTOR_CHUNK_ROWS = 4096, 65536
#: chunked against in-core: fills (Welford against pairwise sums),
#: naive Bayes's log parameters (float32 sums over 1M rows in another
#: order), holdout AuPR
OOC_FILL_RTOL, OOC_NB_TOL, OOC_AUPR_GAP = 1e-9, 1e-4, 1e-4
#: leg b's floor; leg a's naive Bayes must beat the base rate by this
#: (a CPU run of the port and the JAX package at 200k rows: 0.573 against
#: a base rate of 0.455 and an attainable 0.772)
OOC_AUPR_SHARE, OOC_NB_AUPR_MARGIN = 0.9, 0.08
OOC_DRIFT_ROWS, OOC_LATENCY_REQUESTS = 2000, 200
#: the out_of_core phase runs on the smoke's rows divided by this (1M +
#: 100k -> 500k + 50k), which pays for the events and app phases within
#: the smoke's time limit.  (At 4, 250k + 25k rows, leg c's clean rows
#: drift on Cabin: its PSI sits at the 0.25 threshold, 0.248 at 500k.)
OOC_DEPTH_CUT = 2
#: leg a (bench_ingest's DAG, in-core and chunked, each a child) trains on
#: the first 1/OOC_A_ROWS_CUT of the phase's training rows (all of them
#: before the obs phase; it pays for that phase with the cuts marked
#: "obs" below)
OOC_A_ROWS_CUT = 2
#: the out_of_core phase's leg d (kill and resume): the first
#: OOC_CKPT_ROWS rows of the phase's train CSV and OOC_CKPT_HOLDOUT of its
#: holdout rows, chunks of OOC_CKPT_CHUNK_ROWS (7 chunks), a checkpoint
#: every OOC_CKPT_EVERY chunks, the child killed at save OOC_CKPT_KILL_AT
#: (chunk 4, inside the first fit pass), the resumed probabilities'
#: tolerance against the uninterrupted train's
OOC_CKPT_ROWS, OOC_CKPT_HOLDOUT = 100_000, 10_000
OOC_CKPT_CHUNK_ROWS, OOC_CKPT_EVERY, OOC_CKPT_KILL_AT = 16_384, 2, 1
OOC_CKPT_PROBA_TOL = 1e-6
#: leg d's numbers as predicted before its first run on the card (PERF.md
#: section 6), for a host like the previous final proof run's: seconds of
#: the uninterrupted train, the killed child (its start included) and the
#: resume, the saves of the uninterrupted train and their seconds
OOC_CKPT_PREDICTED = {"uninterrupted_s": [8.0, 20.0],
                      "child_s": [12.0, 25.0], "resume_s": [7.0, 18.0],
                      "checkpoint_saves": 4, "checkpoint_s": [0.1, 2.0]}
#: the refresh_cv phase (6e'), on leg d's CSV rows: leg a's rows (both
#: workflow-CV trains; cut from leg d's 100 000 to keep the smoke within
#: its time limit) and chunks; leg b's base train (3 chunks, so that the
#: refresh's chunks fall where the 100 000-row train's fell) and the
#: relative tolerance of its merged states against leg d's; leg c's rows
#: (cut from 100 000 likewise) and the host budget its tuner plans against
#: (below the projected in-core peak, so the planner streams)
RCV_CV_ROWS, RCV_CHUNK_ROWS = 25_000, 16_384
RCV_BASE_ROWS, RCV_STATE_RTOL = 49_152, 1e-9
RCV_TUNER_ROWS, RCV_TUNER_BUDGET = 25_000, 1 << 20
#: the phase's walls as predicted before its first run on the card
#: (PERF.md section 6), for a host like the previous final proof run's:
#: each leg's seconds; the whole smoke's there and on a host 1.6x slower
#: on host work, revised after the first runs with the depth cuts they
#: called for
REFRESH_CV_PREDICTED = {"a_s": [20.0, 40.0], "b_s": [15.0, 30.0],
                        "c_s": [18.0, 35.0], "phase_s": [55.0, 100.0],
                        "smoke_s": [710.0, 760.0],
                        "smoke_slow_host_s": [980.0, 1080.0]}

# the events phase (6f): examples/bench_events.py's clickstream (its
# per-user distributions; seed 9 for the train log, 10 for the holdout
# log), leg a's users (the holdout's cut from 5 000 to pay for the obs
# phase) and chunk rows, leg b's users, its corrupted lines and its drift
# monitor's window
EV_SEED, EV_HOLD_SEED = 9, 10
EV_USERS, EV_HOLD_USERS, EV_B_USERS = 25_000, 2_500, 2_000
EV_CHUNK_ROWS, EV_B_CHUNK_ROWS = 4096, 256
EV_BAD_LINES = 5
EV_DRIFT_ROWS = 20
#: users of the small log each leg-a child trains on before its baseline
EV_WARM_USERS = 200
HOUR = 3_600_000
DAY = 24 * HOUR
#: streamed against in-core holdout probabilities; the streamed child's
#: RSS delta over the in-core child's (bench_events.py's contract)
EV_PROBA_TOL, EV_RSS_RATIO = 1e-6, 0.5
#: leg a's holdout AuROC floor, fixed before the first chip run: the JAX
#: package's holdout AuROC on this recipe at 5 000 users on the CPU
#: (scripts/events_auroc_floor.py: 0.9576739050423261, LR the winner)
#: less 0.02
EV_AUROC_FLOOR = 0.9576739050423261 - 0.02
# the app phase (6g): the generated Titanic project on a Titanic-shaped
# CSV; its scores against the in-process ones (200 000 rows before the
# selector_options phase, 100 000 before the out_of_core phase's leg d,
# 50 000 before the refresh_cv phase, 25 000 before the obs phase,
# 12 500 before the serving_plane phase)
APP_ROWS = 6_250
APP_SCORE_TOL = 1e-6
#: the selector_options phase: legs b-d's rows (the selector
#: recipe and the Titanic demo's; cut from 200 000 + 20 000, and from
#: 100 000 + 10 000 for the refresh_cv phase, to keep the smoke within
#: its time limit on a slow host), the halving schedule of the default
#: selector's 26 candidates on 1M rows (the JAX package's rung_schedule),
#: the halving winner's holdout AuPR gap to the full sweep's, workflow CV's
#: to the plain train's, the resume's fold-metric tolerance, the kill's
#: save index, the watchdog's factor and the injected sleep in deadlines,
#: leg c's forest size and the halving level check's trees
SO_ROWS, SO_HOLDOUT = 50_000, 5_000
SO_SCHEDULE = [(37_038, 26), (111_112, 9), (333_334, 3), (1_000_000, 1)]
SO_AUPR_GAP = 0.01
SO_CV_AUPR_GAP = 0.02
SO_METRIC_TOL = 1e-6
SO_KILL_AT = 2
SO_WATCHDOG_FACTOR = 2.0
SO_SLOW_FACTOR = 2.5
SO_C_TREES = 20
SO_CHECK_TREES = 10
#: depth cuts that pay for the selector_options, refresh_cv and obs phases
#: within the smoke's time limit: the feature_eng and avro_combined phases
#: run on the Titanic rows and holdout divided by these (1M + 100k before
#: the selector_options phase; avro_combined 4 before the out_of_core
#: phase's leg d and 8 before the obs phase, feature_eng 4 before the
#: refresh_cv phase and 8 before the obs phase)
FE_DEPTH_CUT = 16
AVRO_DEPTH_CUT = 16
#: the regression, multiclass, boosted_multi and xgb_wide phases run on
#: the smoke's rows and holdout divided by this (1M + 100k at first, 2
#: before the refresh_cv phase), so that the smoke ends well
#: within its time limit on a slow host
MODEL_DEPTH_CUT = 4
#: the xgb_wide phase runs on the smoke's rows and holdout divided by this
#: (MODEL_DEPTH_CUT before the serving_plane phase)
WIDE_DEPTH_CUT = 8
#: the validate_explain phase runs on the Titanic rows and holdout divided
#: by this (1M + 100k before the selector_options phase, 2 before the
#: refresh_cv phase, 4 before the obs phase; its holdout must hold
#: VE_LOCO_ROWS)
VE_DEPTH_CUT = 8
#: the titanic phase (and its efb line) runs on the Titanic rows and
#: holdout divided by this (1M + 100k before the obs phase, 2 before the
#: serving_plane phase)
TITANIC_DEPTH_CUT = 4
#: the pivot-block checks: rows (the first of a phase's dataset), timing
#: repetitions, and the times predicted before the first chip run
#: (PERF.md section 6): the card's build and the host's build with
#: its copy, ms at 100 000 rows of the Titanic demo's pivots
PIVOT_CHECK_ROWS, PIVOT_REPS = 100_000, 5
PIVOT_PREDICTED = {"card_ms": [0.1, 2.0], "host_ms": [15.0, 150.0]}
#: the feature_eng phase's options leg: rows and holdout rows (the first
#: of the phase's), the integral fill, its selector's LR regularisation,
#: and its train's seconds as predicted before the first chip run
FE_OPTIONS_ROWS, FE_OPTIONS_HOLDOUT = 100_000, 10_000
FE_OPTIONS_FILL = 7
FE_OPTIONS_PREDICTED = {"train_s": [4.0, 12.0]}
#: the obs phase (4a): the selector's training rows it takes (the first of
#: the selector phase's; 100 000 before the serving_plane phase), the limit on the disabled hooks' cost as a share
#: of the untraced train's wall, the single-row requests the serve phase
#: traces, and the walls predicted (PERF.md section 6; revised after the
#: first chip runs and before the final proof): the untraced and the
#: traced train, the phase, and the whole smoke on a host like the
#: previous final proof run's and on a host 1.6x slower on host work
OBS_ROWS = 50_000
OBS_FRAC_LIMIT = 0.01
OBS_SERVE_REQUESTS = 20
OBS_PREDICTED = {"untraced_s": [9.0, 12.5], "traced_s": [26.0, 44.0],
                 "phase_s": [42.0, 70.0], "smoke_s": [740.0, 775.0],
                 "smoke_slow_host_s": [1060.0, 1080.0]}
#: the wall of the smoke's final proof run before the serving_plane phase
#: was added (the H100 at 700 W), printed beside its total, and the whole
#: smoke as predicted before this version's final proof (PERF.md section
#: 6): on a host like that run's, and on a host 1.6x slower on host work
SMOKE_PREVIOUS_S = 701.3
SMOKE_PREDICTED = {"smoke_s": [690.0, 760.0],
                   "smoke_slow_host_s": [990.0, 1070.0]}
#: seconds after which the script writes every thread's stack to stderr
#: (it goes on running): what a run stopped at the 1 200 s limit was doing
STACKS_AT_S = 1_100


def _smi(query: str) -> str:
    """The first card's line of ``nvidia-smi --query-gpu=<query>``."""
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line carries ``at_s``, the seconds since
    the script started, and is announced on stderr as well (the end of
    stderr then shows how far a run got)."""
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - _T0}
        print(f"chip_smoke: {obj['phase']} at {obj['at_s']:.1f} s",
              file=sys.stderr, flush=True)
    print(json.dumps(obj), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device milliseconds of ``fn`` over ``reps`` runs, each
    bracketed by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        evs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in evs)


def device_ms(fn, reps: int = 5, tries: int = 10) -> dict:
    """Device milliseconds per call of ``fn``, by kernel name, over
    ``reps`` calls under torch.profiler (the card's own time, free of the
    host's launch gaps).  The profiler can drop device events, sometimes
    in several sessions running: a session in which some kernel ran a
    number of times that is not a multiple of ``reps``, or none ran, lost
    some, and is taken again half a second later (a ``profiler_retry``
    line says so), at most ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(tries):
        if attempt:
            time.sleep(0.5)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if e.device_time_total > 0]
        counts = {e.key: e.count for e in evs}
        if evs and all(c % reps == 0 for c in counts.values()):
            return {e.key: e.device_time_total / reps / 1e3 for e in evs}
        emit({"phase": "profiler_retry", "attempt": attempt + 1,
              "reps": reps, "counts": counts})
    raise RuntimeError(f"check failed: the profiler dropped device events "
                       f"in {tries} sessions")


def pivot_checks(model, ds, path: str) -> dict:
    """The card-built pivot block of every OneHot, MultiPickList and
    SmartText model of ``model`` on the first PIVOT_CHECK_ROWS rows of
    ``ds`` (which holds their inputs) against the host build of the same
    indices (``pivot_block_host`` and one copy): bitwise, both timed.
    Emits a ``pivot_block`` line."""
    kinds = (OneHotVectorizerModel, MultiPickListVectorizerModel,
             SmartTextVectorizerModel)
    part = ds.slice(0, min(len(ds), PIVOT_CHECK_ROWS))
    rows = []
    for st in model.stages:
        if not isinstance(st, kinds):
            continue
        t0 = time.perf_counter()
        n, width, r, c = st.pivot_ones(*[part[k] for k in st.input_names])
        indices_s = time.perf_counter() - t0
        card = pivot_block(n, width, r, c, "cuda")
        host = torch.from_numpy(pivot_block_host(n, width, r, c)).cuda()
        rows.append({
            "stage": type(st).__name__, "rows": n, "width": width,
            "ones": len(r), "indices_s": indices_s,
            "bitwise_equal": bool(torch.equal(card, host)),
            "card_ms": time_ms(lambda: pivot_block(n, width, r, c, "cuda"),
                               PIVOT_REPS, warmup=1),
            "host_ms": time_ms(lambda: torch.from_numpy(pivot_block_host(
                n, width, r, c)).cuda(), PIVOT_REPS, warmup=1)})
        del card, host
    line = {"phase": "pivot_block", "path": path, "stages": rows,
            "predicted": PIVOT_PREDICTED}
    emit(line)
    check(rows and all(x["bitwise_equal"] for x in rows),
          f"pivot_block {path}: the card's block differs from the host's "
          f"or no pivot ran: {rows}")
    return line


def pass_ms(by_kernel: dict, name: str) -> float:
    """The device ms of the ``seg_hist_<name>`` pass in ``device_ms``'s
    result."""
    ms = [t for k, t in by_kernel.items() if f"seg_hist_{name}" in k]
    check(len(ms) == 1, f"no single seg_hist_{name} pass in {by_kernel}")
    return ms[0]


def make_data(rows: int, cols: int, seed: int = 11):
    """examples/bench_scale.py's ``make_data`` recipe, as numpy arrays."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(rows, cols)).astype(np.float32)
    beta = np.zeros(cols, np.float32)
    informative = rng.choice(cols, max(3, cols // 20), replace=False)
    beta[informative] = rng.normal(size=len(informative)) * 1.5
    z = X @ beta + 0.5 * rng.normal(size=rows).astype(np.float32)
    y = (1 / (1 + np.exp(-z)) > rng.random(rows)).astype(np.float32)
    return X, y


def phase_build() -> None:
    t0 = time.perf_counter()
    _, log = build("seg_hist")
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "Compiling entry" in ln or "spill" in ln]
    spills = [int(x) for ln in ptxas
              for x in re.findall(r"(\d+) bytes spill (?:stores|loads)", ln)]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "source": SEG_HIST_SOURCE, "ptxas": ptxas})
    check(spills, "build: the ptxas report shows no spill counts")
    check(not any(spills), "build: ptxas reports register spills")


def _level_binned(dev, n: int, d: int, B: int, gen):
    """Random bins in the main path's row layout (rows padded as
    ``apply_bins`` pads them)."""
    binned = gk.binned_empty(n, d, dev)
    binned.copy_(torch.randint(0, B, (n, d), dtype=torch.uint8, device=dev,
                               generator=gen))
    return binned


def _apply_bins_497(dev, n: int, B: int, gen):
    """A binned matrix of d=497 columns (not a multiple of 4) made by
    ``apply_bins`` from normal columns, with the normal law's B-quantiles
    as every column's edges."""
    d = 497
    X = torch.randn(n, d, device=dev, generator=gen)
    qs = [statistics.NormalDist().inv_cdf(k / B) for k in range(1, B)]
    binned = gk.apply_bins(X, np.tile(np.asarray(qs, np.float32), (d, 1)))
    del X
    check(binned.stride() == (512, 1), f"apply_bins rows {binned.stride()}")
    return binned


def _compare(args) -> dict:
    """Two launches and the plain version on the same inputs."""
    k1 = gk.seg_level_hists(*args)
    k2 = gk.seg_level_hists(*args)
    plain = gk.seg_level_hists_plain(*args)
    torch.cuda.synchronize()
    diff = (k1 - plain).abs()
    out = {"max_abs_err": float(diff.max()),
           "max_rel_err": float((diff / plain.abs().clamp(min=1.0)).max()),
           "tol_ratio": float((diff / (ATOL + RTOL * plain.abs())).max()),
           "bitwise_equal": bool(torch.equal(k1, plain)),
           "deterministic": bool(torch.equal(k1, k2)),
           "odd_slots_zero": bool((k1[:, 1::2] == 0).all())}
    return out


def _rf_level(dev, n: int, d: int, B: int, gen):
    """A forest level's inputs: bins of a d-column feature subset gathered
    into rows padded to 16 bytes (as the forest grower gathers them), and
    the channels (bw [y=0], bw) of Poisson(1) bag counts."""
    binned = _level_binned(dev, n, d, B, gen)
    bw = torch.poisson(torch.ones(n, device=dev), generator=gen)
    y0 = (torch.rand(n, device=dev, generator=gen) < 0.5).to(torch.float32)
    return binned, torch.stack([bw * y0, bw], 1).contiguous()


def _reg_levels(dev, n: int, d: int, B: int, gen):
    """The regression paths' level inputs at the regression phase's
    checked width ``d``: a forest level's d // 3-column subset gathered
    into rows padded to 16 bytes, with channels (bw y, bw) of Poisson(1)
    bags and a Boston-scaled label (mean 22.5, sd 9); a boosted chain's
    full-width level, with channels (w (F - y), w) of 0/1 fold weights at
    the label's mean margin."""
    y = 22.5 + 9.0 * torch.randn(n, device=dev, generator=gen)
    bw = torch.poisson(torch.ones(n, device=dev), generator=gen)
    rf = (_level_binned(dev, n, max(1, d // 3), B, gen),
          torch.stack([bw * y, bw], 1).contiguous())
    w = (torch.rand(n, device=dev, generator=gen) < 2 / 3).to(torch.float32)
    gbt = (_level_binned(dev, n, d, B, gen),
           torch.stack([w * (22.5 - y), w], 1).contiguous())
    return rf, gbt


def phase_seg_hist(dev, n: int, d: int, d_reg: int, reps: int, bw: float,
                   f32: float, smem_bw: float):
    """Kernel vs plain at every level shape of a depth-6 round (M = 1..32),
    an M=32 level whose odd slots are empty, the level shapes of depths 7
    and 10 (M=64, 512), d=497 through apply_bins' padded rows, an M=32
    level of unpadded rows (stride 500: 4-byte row copies), and the
    forests' levels: d = floor(sqrt(500)) = 22 in 32-byte rows, integer
    channels, M = 1, 64, 512, 1024, 2048 (depth 12's last level), where
    the kernel must equal the plain version bitwise; at the regression
    phase's checked width ``d_reg``, the regression forests' levels (d =
    d_reg // 3, float channels (bw y, bw), M = 1, 64, 512, 2048) and the
    GBT chains' depth-12 levels (d = d_reg, float channels (w (F - y), w),
    M = 1024, 2048), held to the tolerance and to bitwise
    repeatability.  Rows with ``in_mean`` make the ``kernels``
    line's means."""
    B, nchan = 32, 2
    gen = torch.Generator(device=dev).manual_seed(0)
    binned = _level_binned(dev, n, d, B, gen)
    ch_main = torch.stack([torch.rand(n, device=dev, generator=gen) * 2 - 1,
                           torch.rand(n, device=dev, generator=gen) * 0.25],
                          dim=1).contiguous()
    d_rf = int(d ** 0.5)
    rf_binned, ch_rf = _rf_level(dev, n, d_rf, B, gen)
    (reg_binned, ch_reg), (gbt_binned, ch_gbt) = _reg_levels(dev, n, d_reg,
                                                             B, gen)
    cases = [(M, False, "main") for M in (1, 2, 4, 8, 16, 32)]
    cases += [(32, True, "main"), (64, False, "main"), (512, False, "main"),
              (32, False, "d497"), (32, False, "dense")]
    cases += [(M, False, "rf") for M in (1, 64, 512, 1024, 2048)]
    cases += [(M, False, "rf_reg") for M in (1, 64, 512, 2048)]
    cases += [(M, False, "gbt_d12") for M in (1024, 2048)]
    rows = []
    for M, even, which in cases:
        ch = {"rf": ch_rf, "rf_reg": ch_reg, "gbt_d12": ch_gbt}.get(
            which, ch_main)
        if which == "main":
            b = binned
        elif which == "gbt_d12":
            b = gbt_binned
        elif which == "rf":
            b = rf_binned
        elif which == "rf_reg":
            b = reg_binned
        elif which == "d497":
            b = _apply_bins_497(dev, n, B, gen)
        else:   # unpadded rows (stride d): the kernel's 4-byte row copies
            b = binned.contiguous()
        dd = b.shape[1]
        hi = M // 2 if even else M
        slot = torch.randint(0, hi, (n,), dtype=torch.int32, device=dev,
                             generator=gen)
        if even:
            slot = (2 * slot).contiguous()
        args = (b, slot, ch, M, B)
        cmp = _compare(args)
        kernel_ms = time_ms(lambda: gk.seg_level_hists(*args), reps)
        # the layout alone is a few small ops: timed by events, the host's
        # launch gaps between them would count, so take its device time
        layout_ms = sum(device_ms(lambda: gk.seg_layout(slot, M)).values())
        passes = device_ms(lambda: gk.seg_level_hists(*args))
        plain_ms = time_ms(lambda: gk.seg_level_hists_plain(*args), 3, 1)
        library_ms = _library_ms(b, slot, ch, M, B)
        nbytes = n * dd + n * 4 + n * nchan * 4 + M * nchan * B * dd * 4
        ops = n * dd * nchan
        bound_ms = max(nbytes / bw, ops / f32) * 1e3
        row = {"phase": "seg_hist", "N": n, "d": dd, "B": B, "nchan": nchan,
               "M": M, "empty_slots": even, "path": which,
               "row_stride": b.stride(0),
               "in_mean": which == "main" and not even and M <= 32,
               "max_abs_err": cmp["max_abs_err"],
               "max_rel_err": cmp["max_rel_err"],
               "tol_ratio": cmp["tol_ratio"],
               "bitwise_equal": cmp["bitwise_equal"],
               "deterministic": cmp["deterministic"],
               "empty_slots_zero": cmp["odd_slots_zero"] if even else None,
               "kernel_ms": kernel_ms, "layout_ms": layout_ms,
               "kernel_only_ms": kernel_ms - layout_ms,
               "groups_ms": pass_ms(passes, "groups"),
               "reduce_ms": pass_ms(passes, "reduce"),
               "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound_ms,
               "bound_by": "bytes" if nbytes / bw >= ops / f32
               else "operations",
               "smem_floor_ms": 16 * n * dd / smem_bw * 1e3,
               "bytes": nbytes, "kernel_GBps": nbytes / kernel_ms / 1e6}
        emit(row)
        what = f"seg_hist M={M} d={dd}"
        check(row["deterministic"], f"{what}: two launches differ")
        check(row["tol_ratio"] <= 1.0, f"{what}: kernel vs plain error "
              f"{row['max_abs_err']} beyond rtol {RTOL} / atol {ATOL}")
        check(which != "rf" or row["bitwise_equal"],
              f"{what}: integer channels, yet the kernel differs from the "
              f"plain version by {row['max_abs_err']}")
        check(row["empty_slots_zero"] is not False,
              f"{what}: empty slots not 0")
        rows.append(row)
        del b, args
    del binned, ch_main, rf_binned, ch_rf, reg_binned, ch_reg, gbt_binned
    del ch_gbt
    return rows


def phase_seg_hist_channels(dev, n: int, reps: int, bw: float, f32: float,
                            smem_bw: float) -> list:
    """The kernel at C channels: K-class forest levels (d = 22 subset
    columns in 32-byte rows, integer channels (bw [y=0], .., bw [y=C-2],
    bw) of Poisson bags and uniform labels) at every C of SWEEP_CHANNELS
    and M of SWEEP_SLOTS, each bitwise equal to the plain version; and
    one float-channel level (C = 10, d = 500, M = 32: a 5-class softmax
    objective's gradients and hessians) within the tolerance.  Per case:
    ms, plain and library ms, the bytes bound, the shared-memory floor
    (8C bytes of shared memory read and written a (row, column)) and the
    channel groups launched."""
    B = 32
    gen = torch.Generator(device=dev).manual_seed(1)
    d_rf = 22
    binned = _level_binned(dev, n, d_rf, B, gen)
    bag = torch.poisson(torch.ones(n, device=dev), generator=gen)
    cases = [(C, M, False) for C in SWEEP_CHANNELS for M in SWEEP_SLOTS]
    cases.append((10, 32, True))
    rows = []
    for C, M, fl in cases:
        if fl:
            b = _level_binned(dev, n, 500, B, gen)
            ch = (torch.rand((n, C), device=dev, generator=gen) * 2 - 1)
        else:
            b = binned
            lab = torch.randint(0, C, (n,), device=dev, generator=gen)
            ch = torch.stack([bag * (lab == k) for k in range(C - 1)]
                             + [bag], 1).contiguous()
        slot = torch.randint(0, M, (n,), dtype=torch.int32, device=dev,
                             generator=gen)
        args = (b, slot, ch, M, B)
        before = gk.seg_level_hists.launches
        k1 = gk.seg_level_hists(*args)
        groups = gk.seg_level_hists.launches - before
        k2 = gk.seg_level_hists(*args)
        plain = gk.seg_level_hists_plain(*args)
        torch.cuda.synchronize()
        diff = (k1 - plain).abs()
        tol_ratio = float((diff / (ATOL + RTOL * plain.abs())).max())
        dd = b.shape[1]
        kernel_ms = time_ms(lambda: gk.seg_level_hists(*args), reps)
        plain_ms = time_ms(lambda: gk.seg_level_hists_plain(*args), 3, 1)
        library_ms = _library_ms(b, slot, ch, M, B)
        nbytes = n * dd + n * 4 + n * C * 4 + M * C * B * dd * 4
        ops = n * dd * C
        row = {"phase": "seg_hist_channels", "N": n, "d": dd, "B": B,
               "nchan": C, "M": M, "float_channels": fl,
               "channel_groups": [list(g) for g in
                                  gk.seg_channel_groups(C, B)],
               "launches_per_level": groups,
               "warps_per_block": gk.seg_plan(
                   n, dd, M, B, gk.seg_channel_groups(C, B)[0][1]).warps,
               "max_abs_err": float(diff.max()), "tol_ratio": tol_ratio,
               "bitwise_equal": bool(torch.equal(k1, plain)),
               "deterministic": bool(torch.equal(k1, k2)),
               "kernel_ms": kernel_ms, "plain_ms": plain_ms,
               "library_ms": library_ms,
               "bound_ms": max(nbytes / bw, ops / f32) * 1e3,
               "bound_by": "bytes" if nbytes / bw >= ops / f32
               else "operations",
               "smem_floor_ms": 8 * C * n * dd / smem_bw * 1e3,
               "bytes": nbytes}
        emit(row)
        what = f"seg_hist C={C} M={M} d={dd}"
        check(row["deterministic"], f"{what}: two launches differ")
        check(groups == len(gk.seg_channel_groups(C, B)),
              f"{what}: {groups} launches, not one per channel group")
        check(fl or row["bitwise_equal"], f"{what}: integer channels, yet "
              f"the kernel differs from the plain version by "
              f"{row['max_abs_err']}")
        check(tol_ratio <= 1.0, f"{what}: kernel vs plain error "
              f"{row['max_abs_err']} beyond rtol {RTOL} / atol {ATOL}")
        rows.append(row)
        del k1, k2, plain, diff, args, ch, slot
        if fl:
            del b
    del binned, bag
    return rows


def phase_tree(dev) -> None:
    """One depth-6 tree with the XGBoost defaults, grown through the kernel,
    through the plain version on the card and on the CPU."""
    X, y = make_data(50_000, 64)
    edges = gk.quantile_bins(torch.from_numpy(X), 32)
    p0 = float(y.mean())
    kw = dict(max_depth=6, n_bins=32, lam=1.0, min_child_weight=1.0,
              min_gain_raw=0.8, learning_rate=0.02, default_dir=True)
    trees = {}
    for name, where, fn in [("kernel", dev, gk.seg_level_hists),
                            ("plain_cuda", dev, gk.seg_level_hists_plain),
                            ("plain_cpu", torch.device("cpu"),
                             gk.seg_level_hists_plain)]:
        Xt = torch.from_numpy(X).to(where)
        yt = torch.from_numpy(y).to(where)
        binned = gk.apply_bins(Xt, edges)
        G = (p0 - yt)[:, None].contiguous()
        H = torch.full_like(G, p0 * (1 - p0))
        dd = torch.from_numpy(gk.default_dir_mask(edges)).to(where)
        if name == "kernel":
            # growth must never wait on the host: any synchronising op that
            # torch's sync debug mode detects raises here
            gk.grow_tree(binned, G, H, dd_mask=dd, hist_fn=fn, **kw)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                tree = gk.grow_tree(binned, G, H, dd_mask=dd, hist_fn=fn, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        else:
            tree = gk.grow_tree(binned, G, H, dd_mask=dd, hist_fn=fn, **kw)
        trees[name] = [t.cpu() for t in tree]
    k = trees["kernel"]
    same = {n: bool(torch.equal(k[0], t[0]) and torch.equal(k[1], t[1]))
            for n, t in trees.items() if n != "kernel"}
    leaf_err = {n: float((k[2] - t[2]).abs().max())
                for n, t in trees.items() if n != "kernel"}
    splits = int((k[1] < 32).sum())
    rf = _rf_grid_kernel_vs_plain(dev, X, y, edges)
    emit({"phase": "tree", "rows": 50_000, "cols": 64, "depth": 6,
          "splits": splits, "same_splits": same, "leaf_max_abs_diff": leaf_err,
          "growth_sync_debug_mode": "error", "raised": False, "forest": rf})
    check(splits > 0, "tree: no split grown")
    check(all(same.values()), f"tree: splits differ {same}")
    check(rf["splits"] > 0 and rf["same_trees"],
          f"tree: forests through the kernel and the plain version differ "
          f"{rf}")


def _rf_grid_kernel_vs_plain(dev, X, y, edges) -> dict:
    """A forest grid (3 folds x 2 gates x 3 trees, depth 8, 8-feature
    subsets, Poisson bags) grown on the card through the kernel and
    through the plain version: integer channels, so identical trees."""
    Xt = torch.from_numpy(X).to(dev)
    binned = gk.apply_bins(Xt, edges)
    folds = torch.arange(len(y), device=dev) % 3
    W = torch.stack([(folds != k).to(torch.float32) for k in range(3)])
    kw = dict(seed=5, n_trees=3, pair_fold=[0, 1, 2, 0, 1, 2],
              pair_min_ig=[0.001] * 3 + [0.01] * 3,
              pair_min_inst=[10] * 3 + [100] * 3, pair_depth=[8] * 6,
              msub=8, subsample_rate=1.0, n_bins=32, leaf_levels=(3,))
    yt = torch.from_numpy(y).to(dev)
    got = [gk.grow_rf_grid(binned, yt, W, hist_fn=fn, **kw)
           for fn in (gk.seg_level_hists, gk.seg_level_hists_plain)]
    a, b = got
    return {"pairs": 6, "trees": 3, "depth": 8,
            "splits": int((a.thresh < 32).sum()), "levels": a.levels,
            "same_trees": bool(torch.equal(a.feat, b.feat)
                               and torch.equal(a.thresh, b.thresh)
                               and torch.equal(a.leaf, b.leaf)
                               and torch.equal(a.snaps[3], b.snaps[3]))}


def _dataset(X, y) -> ColumnarDataset:
    cols = {f"f{j}": FeatureColumn.from_values(ft.Real, X[:, j])
            for j in range(X.shape[1])}
    cols["label"] = FeatureColumn.from_values(ft.RealNN, y)
    return ColumnarDataset(cols)


def _rows_cut(data, k: int):
    """``make_datasets``' datasets cut to the first 1/k of the rows and
    of the holdout (views, not copies)."""
    train, hold, data_s = data
    return (train.slice(0, len(train) // k), hold.slice(0, len(hold) // k),
            data_s)


def make_datasets(rows: int, holdout: int, cols: int):
    """(train, holdout, seconds): the slice's and the selector's data, made
    once (set-up, not part of either train)."""
    t0 = time.perf_counter()
    X, y = make_data(rows + holdout, cols)
    train, hold = _dataset(X[:rows], y[:rows]), _dataset(X[rows:], y[rows:])
    return train, hold, time.perf_counter() - t0


def phase_slice(data, cols: int, rounds: int) -> dict:
    train, hold, data_s = data
    rows, holdout = len(train), len(hold)

    label = FeatureBuilder.RealNN("label").as_response()
    preds = [FeatureBuilder.Real(f"f{j}").as_predictor() for j in range(cols)]
    checked = label.transform_with(SanityChecker(max_correlation=0.99),
                                   transmogrify(preds))
    depth = 6
    est = OpXGBoostClassifier(max_depth=depth, num_round=rounds)
    pred = label.transform_with(est, checked)
    wf = OpWorkflow().set_result_features(pred).set_input_data(train)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gk.seg_level_hists.launches = 0
    t0 = time.perf_counter()
    model = wf.train()
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scored, metrics = model.score_and_evaluate(
        Evaluators.BinaryClassification.auPR(), data=hold)
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    launches = gk.seg_level_hists.launches

    proba = scored[pred.name].values.probability
    rounds_grown = est.metadata["rounds_grown"]
    timing = est.metadata["fit_timing"]
    aupr = float(metrics["AuPR"])
    served = {"name": "xgb", "model": model, "pred": pred, "proba": proba,
              "hold": hold}
    out = {"phase": "slice", "rows": rows, "holdout": holdout, "cols": cols,
           "max_depth": depth, "num_round": rounds,
           "num_round_cut_from": FULL_ROUNDS if rounds < FULL_ROUNDS else None,
           "data_s": data_s, "train_s": train_s, "score_s": score_s,
           "stage_seconds": model.stage_seconds,
           "binning_s": timing["binning_s"],
           "boosting_s": timing["boosting_s"],
           "rounds_grown": rounds_grown, "best_len": est.metadata["best_len"],
           "ms_per_round": timing["boosting_s"] / rounds_grown * 1e3,
           "holdout_aupr": aupr, "seg_hist_launches": launches,
           "expected_launches": depth * rounds_grown,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "dropped_columns": len(checked.origin_stage.metadata["summary"]
                                  ["dropped"]),
           # the fit's split: fills and the drift baselines' moments, and
           # the baselines' histograms
           "real_vectorizer_fit_s": next(
               s.fit_seconds for s in compute_dag([pred]).all_stages()
               if isinstance(s, RealVectorizer))}
    emit(out)
    check(tuple(proba.shape) == (holdout, 2), f"proba shape {proba.shape}")
    check(bool(torch.isfinite(proba).all()), "non-finite probabilities")
    check(launches > 0 and launches == depth * rounds_grown,
          f"seg_hist launches {launches} != {depth} x {rounds_grown}")
    check(0.6 < aupr <= 1.0, f"holdout AuPR {aupr} outside (0.6, 1]")
    return out, served


def phase_selector(data, cols: int) -> dict:
    """The default binary model selector on the slice's data: 26
    candidates under 3-fold CV, the winner refit on the training split."""
    train, hold, _ = data
    rows, holdout = len(train), len(hold)

    label = FeatureBuilder.RealNN("label").as_response()
    preds = [FeatureBuilder.Real(f"f{j}").as_predictor() for j in range(cols)]
    checked = label.transform_with(SanityChecker(max_correlation=0.99),
                                   transmogrify(preds))
    selector = BinaryClassificationModelSelector.with_cross_validation()
    pred = label.transform_with(selector, checked)
    wf = OpWorkflow().set_result_features(pred).set_input_data(train)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gk.seg_level_hists.launches = 0
    coll = MetricsCollector()
    t0 = time.perf_counter()
    with install_collector(coll):
        model = wf.train()
    train_s = time.perf_counter() - t0
    launches = gk.seg_level_hists.launches
    t0 = time.perf_counter()
    scored, metrics = model.score_and_evaluate(
        Evaluators.BinaryClassification.auPR(), data=hold)
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0

    meta = selector.metadata
    summary = meta["model_selector_summary"]
    results = summary["validationResults"]
    proba = scored[pred.name].values.probability
    aupr = float(metrics["AuPR"])
    served = {"name": "selector", "model": model, "pred": pred,
              "proba": proba, "hold": hold}
    out = {"phase": "selector", "rows": rows, "holdout": holdout,
           "cols": cols, "folds": selector.validator.num_folds,
           "train_s": train_s, "score_s": score_s,
           "stage_seconds": model.stage_seconds,
           "sweep_seconds": meta["sweep_seconds"],
           "group_errors": meta["group_errors"],
           "tree_phase_seconds": meta["tree_phase_seconds"],
           "refit_seconds": meta["refit_seconds"],
           "metrics_seconds": meta["metrics_seconds"],
           "winner": summary["bestModelType"],
           "winner_params": summary["bestModelParams"],
           "cv": [{"model": r["modelType"], "params": r["params"],
                   "metric": r["metricValue"], "error": r.get("error")}
                  for r in results],
           "train_metrics": summary["trainEvaluationMetrics"],
           "holdout_metrics": summary["holdoutMetrics"],
           "holdout_aupr": aupr, "rf_trees": meta["rf_trees"],
           "seg_hist_launches": launches,
           "growers_hist_levels": meta["hist_levels"],
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "dropped_columns": len(checked.origin_stage.metadata["summary"]
                                  ["dropped"]),
           # the fit's split: fills and the drift baselines' moments, and
           # the baselines' histograms
           "real_vectorizer_fit_s": next(
               s.fit_seconds for s in compute_dag([pred]).all_stages()
               if isinstance(s, RealVectorizer)),
           # the tree-prep prefetch thread: its seconds (the collector's
           # tag) and its state after the fit
           "prefetchTreePrepSecs": coll.metrics.custom_tags.get(
               "prefetchTreePrepSecs"),
           "tree_prefetch": meta.get("tree_prefetch")}
    emit(out)
    check(tuple(proba.shape) == (holdout, 2), f"proba shape {proba.shape}")
    check(bool(torch.isfinite(proba).all()), "non-finite probabilities")
    check((meta.get("tree_prefetch") or {}).get("joined")
          and selector._prep_thread is None,
          f"the tree-prep prefetch thread was not joined: "
          f"{meta.get('tree_prefetch')}")
    check(len(results) == 26, f"{len(results)} validation results, not 26")
    errors = [r["error"] for r in results if r.get("error")]
    check(not errors, f"candidates failed: {errors}")
    # a failed group's members pass as sequential fits: the batched groups
    # must have run and raised nothing
    check(not meta["group_errors"],
          f"grid groups failed: {meta['group_errors']}")
    check({"LogRegGridGroup", "RFGridGroup"} <= set(meta["sweep_seconds"]),
          f"grid groups not run: {sorted(meta['sweep_seconds'])}")
    check(launches > 0 and launches == meta["hist_levels"],
          f"seg_hist launches {launches} != the growers' "
          f"{meta['hist_levels']} histogram levels")
    check(0.6 < aupr <= 1.0, f"holdout AuPR {aupr} outside (0.6, 1]")
    return out, served


def _obs_train(train, cols: int):
    """(model, selector, seconds, seg_hist launches) of the default binary
    selector's ``train(profile=True)`` on ``train``."""
    selector = BinaryClassificationModelSelector.with_cross_validation()
    pred, _ = _selector_pipeline(cols, selector)
    wf = OpWorkflow().set_result_features(pred).set_input_data(train)
    torch.cuda.synchronize()
    launches0 = gk.seg_level_hists.launches
    t0 = time.perf_counter()
    model = wf.train(profile=True)
    torch.cuda.synchronize()
    return (model, selector, time.perf_counter() - t0,
            gk.seg_level_hists.launches - launches0)


def obs_child(tmp: str, cols: int) -> None:
    """The obs phase's two trains, in a process of their own (``--obs-child
    DIR``): the default selector on DIR's x.npy / y.npy, untraced, then
    under ``obs.start_trace()`` with the kernel mix; writes the Chrome
    trace (DIR/trace.json) and the readings (DIR/obs.json).  A process of
    its own because the first torch.profiler session starts kineto's
    clock, and device events of sessions many minutes later (the smoke's
    seg_hist and profile phases) then fall outside their windows."""
    X, y = np.load(os.path.join(tmp, "x.npy")), np.load(
        os.path.join(tmp, "y.npy"))
    train = _dataset(X, y)
    del X
    tprof.reset_counters()
    m0, sel0, untraced_s, launches0 = _obs_train(train, cols)
    tracer = obs.start_trace("chip_smoke.obs")
    try:
        m1, sel1, traced_s, launches1 = _obs_train(train, cols)
    finally:
        obs.stop_trace()
    ledger = tprof.COUNTERS.to_json()
    spans = tracer.snapshot()
    events = tracer.flight.events()
    doc = obs.to_chrome_trace(tracer)
    path = os.path.join(tmp, "trace.json")
    with open(path, "w") as fh:
        json.dump(doc, fh)
    stage, stage0 = (next(sp for sp in m.train_profile.stages
                          if sp.op == "ModelSelector") for m in (m1, m0))
    hooks = len(spans) + len(events)
    disabled_s = obs.estimate_disabled_overhead_s(hooks)
    summ0 = sel0.metadata["model_selector_summary"]
    summ1 = sel1.metadata["model_selector_summary"]
    res = {"untraced_s": untraced_s, "traced_s": traced_s,
           "spans": len(spans), "events": len(events),
           "categories": sorted({sp.cat for sp in spans}),
           "dropped_spans": doc["otherData"]["droppedSpans"],
           "chrome_problems": obs.validate_chrome_trace(doc),
           "trace_bytes": os.path.getsize(path),
           "stage_wall_s": stage.wall_s, "stage_launches": stage.launches,
           "untraced_stage_wall_s": stage0.wall_s,
           "stage_hlo": stage.hlo,
           "stage_mix_fields": {sp.op: sorted(sp.hlo) for sp in
                                m1.train_profile.stages},
           "launches": [launches0, launches1], "ledger": ledger,
           "disabled_hooks_s": disabled_s,
           "winners": [[summ0["bestModelType"], summ0["bestModelParams"]],
                       [summ1["bestModelType"], summ1["bestModelParams"]]],
           "bench_meta": obs.bench_meta(wall_s=traced_s)}
    with open(os.path.join(tmp, "obs.json"), "w") as fh:
        json.dump(res, fh, default=str)


def phase_obs(data, cols: int) -> Tuple[dict, dict]:
    """Observability on the card (the module docstring's phase 4a): the
    default selector on the first OBS_ROWS training rows, untraced, then
    under ``obs.start_trace()`` with the kernel mix captured, both in a
    child (``obs_child``); the Chrome export validated; the selector
    stage's profiled ``seg_hist`` kernels against its launches; the
    disabled hooks' cost against the untraced wall; the transfer ledger.
    ``python -m transmogrifai_tpu_torch trace`` then summarizes the export
    in a child that runs beside the next phase: returns the phase's line
    and that child, for ``finish_obs_cli``."""
    phase_t0 = time.perf_counter()
    train = data[0]
    tmp = tempfile.mkdtemp(prefix="tmog_obs_")
    try:
        np.save(os.path.join(tmp, "x.npy"), np.stack(
            [np.asarray(train[f"f{j}"].values[:OBS_ROWS])
             for j in range(cols)], axis=1))
        np.save(os.path.join(tmp, "y.npy"),
                np.asarray(train["label"].values[:OBS_ROWS]))
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--obs-child", tmp,
             "--cols", str(cols)], capture_output=True, text=True,
            timeout=900)
        child_s = time.perf_counter() - t0
        check(child.returncode == 0, f"obs: the child failed (exit "
              f"{child.returncode}): {child.stderr[-2000:]}")
        with open(os.path.join(tmp, "obs.json")) as fh:
            res = json.load(fh)
        cli = subprocess.Popen(
            [sys.executable, "-m", "transmogrifai_tpu_torch", "trace",
             os.path.join(tmp, "trace.json"), "--top", "5"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    mix = res["stage_hlo"]
    ops = mix.get("ops", {})
    groups = sum(n for k, n in ops.items() if "seg_hist_groups" in k)
    reduces = sum(n for k, n in ops.items() if "seg_hist_reduce" in k)
    launches0, launches1 = res["launches"]
    untraced_s, traced_s = res["untraced_s"], res["traced_s"]
    frac = res["disabled_hooks_s"] / untraced_s
    stage_launches = res["stage_launches"]
    out = {"phase": "obs", "rows": OBS_ROWS, "cols": cols,
           "untraced_s": untraced_s, "traced_s": traced_s,
           "traced_overhead_s": traced_s - untraced_s,
           "traced_over_untraced": traced_s / untraced_s,
           "child_s": child_s,
           **{k: res[k] for k in ("spans", "events", "dropped_spans",
                                  "categories", "trace_bytes",
                                  "stage_mix_fields", "ledger",
                                  "disabled_hooks_s", "winners",
                                  "bench_meta")},
           "chrome_problems": res["chrome_problems"][:5],
           "selector_stage": {
               "wall_s": res["stage_wall_s"], "launches": stage_launches,
               "untraced_wall_s": res["untraced_stage_wall_s"],
               "profiled_programs": mix.get("programs"),
               "profiled_seg_hist_groups": groups,
               "profiled_seg_hist_reduce": reduces,
               "device_s": mix.get("deviceSecs"),
               "kernel_time_share": (mix.get("deviceSecs", 0.0)
                                     / res["stage_wall_s"]),
               # the card's kernel time against the untraced stage's wall:
               # the busy share of the selector stage as users run it
               "kernel_time_share_untraced": (
                   mix.get("deviceSecs", 0.0)
                   / res["untraced_stage_wall_s"]),
               "top_kernels": [(k[:80], n) for k, n in sorted(
                   ops.items(), key=lambda kv: -kv[1])[:8]]},
           "seg_hist_launches": launches0 + launches1,
           "launches_untraced_traced": [launches0, launches1],
           "obs_frac_of_train": frac, "obs_frac_limit": OBS_FRAC_LIMIT,
           "predicted": OBS_PREDICTED,
           "phase_s": time.perf_counter() - phase_t0}
    emit(out)
    pending = {"proc": cli, "tmp": tmp, "t0": time.perf_counter()}
    try:
        check(not res["chrome_problems"] and out["dropped_spans"] == 0,
              f"obs: the Chrome trace is invalid "
              f"({res['chrome_problems'][:3]}) or dropped "
              f"{out['dropped_spans']} spans")
        check({"workflow", "plan", "stage", "sweep"}
              <= set(out["categories"]),
              f"obs: span categories {out['categories']}")
        check(stage_launches > 0 and stage_launches == launches1
              and groups == stage_launches and reduces == stage_launches,
              f"obs: the profiler saw {groups} seg_hist_groups and "
              f"{reduces} seg_hist_reduce kernels in the selector stage, "
              f"which launched seg_hist {stage_launches} times "
              f"({launches1} in the train)")
        check(out["ledger"]["launchTags"].get("seg_hist")
              == launches0 + launches1,
              f"obs: the ledger's seg_hist launches "
              f"{out['ledger']['launchTags']} != {launches0 + launches1}")
        check(frac < OBS_FRAC_LIMIT, f"obs: {res['spans'] + res['events']} "
              f"disabled hooks cost {res['disabled_hooks_s']} s, {frac} of "
              f"the untraced train")
        check(res["winners"][0] == res["winners"][1],
              f"obs: the traced train chose another winner: "
              f"{res['winners']}")
    except BaseException:
        finish_obs_cli(pending, emit_line=False)
        raise
    return out, pending


def finish_obs_cli(pending: dict, emit_line: bool = True) -> None:
    """Wait for the obs phase's ``trace`` child, print its ``obs_cli``
    line, remove the export, and check that its summary names
    workflow.train."""
    proc = pending["proc"]
    try:
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        shutil.rmtree(pending["tmp"], ignore_errors=True)
    if not emit_line:
        return
    emit({"phase": "obs_cli", "rc": proc.returncode,
          "waited_s": time.perf_counter() - pending["t0"],
          "summary_head": stdout.splitlines()[:8]})
    check(proc.returncode == 0 and "workflow.train" in stdout,
          f"obs: `trace` exited {proc.returncode}: {stderr[-500:]}")


def make_regression_data(data):
    """The regression phase's datasets over the slice's 500 Real columns
    (the same host arrays, no second matrix): an Integral column of 30
    values (5% missing), a PickList of 5 values (5% null) and a RealNN
    label from REG_SEED.  Returns (train, holdout, the largest attainable
    R2 on the training rows, seconds)."""
    train, hold, _ = data
    t0 = time.perf_counter()
    rows, holdout = len(train), len(hold)
    n = rows + holdout
    rng = np.random.default_rng(REG_SEED)
    F = np.stack([np.concatenate([train[f"f{j}"].values,
                                  hold[f"f{j}"].values]) for j in range(12)],
                 axis=1)
    beta = rng.normal(size=10)
    beta *= np.sqrt(REG_LINEAR_VAR / (beta @ beta))
    rad = rng.integers(1, 31, size=n).astype(np.float64)
    rad[rng.random(n) < 0.05] = np.nan
    levels = np.array(["a", "b", "c", "d", "e"], dtype=object)
    chas = levels[rng.integers(0, 5, size=n)]
    chas[rng.random(n) < 0.05] = None
    effect = {"a": 0.0, "b": 1.5, "c": -1.0, "d": 2.5, "e": 0.5, None: 0.0}
    signal = (22.5 + F[:, :10] @ beta + 4 * np.tanh(F[:, 10] * F[:, 11])
              + 0.15 * np.nan_to_num(rad, nan=15.5)
              + np.array([effect[c] for c in chas]))
    y = signal + rng.normal(0.0, np.sqrt(REG_NOISE_VAR), n)
    max_r2 = 1.0 - REG_NOISE_VAR / float(np.var(y[:rows]))

    def dataset(base, sl):
        cols = {k: c for k, c in base.columns.items() if k != "label"}
        cols["rad"] = FeatureColumn.from_values(ft.Integral, rad[sl])
        cols["chas"] = FeatureColumn.from_values(ft.PickList,
                                                 list(chas[sl]))
        cols["label"] = FeatureColumn.from_values(ft.RealNN, y[sl])
        return ColumnarDataset(cols)

    return (dataset(train, slice(0, rows)), dataset(hold, slice(rows, n)),
            max_r2, time.perf_counter() - t0)


def _regression_rows(hold, names, k: int) -> list:
    """The first ``k`` holdout rows as raw-feature dicts (missing values
    as None), as a local-scoring caller sends them."""
    cols = {nm: hold[nm] for nm in names}
    out = []
    for i in range(k):
        row = {}
        for nm, c in cols.items():
            ok = True if c.mask is None else bool(c.mask[i])
            v = c.values[i]
            row[nm] = (None if not ok or v is None
                       else v if isinstance(v, str) else float(v))
        out.append(row)
    return out


class _LevelCheck:
    """A ``hist_fn`` for the growers that builds each level's histograms
    (the kernel, or ``build``) and holds them against the plain version on
    the same level inputs; the growth goes on from the built ones.  Two
    float32 sums of the same terms in another order differ by a few ulps
    of the sum of the terms' magnitudes, and gradients w (F - y) of both
    signs cancel to sums far smaller than that: the tolerance is ATOL +
    RTOL x the histogram of |channels| (the plain version's), not of the
    sums themselves."""

    def __init__(self, build=None):
        # the histogram under test: the kernel, or another function of the
        # same (C, M, B, d) histograms (the CSR path's)
        self.build = gk.seg_level_hists if build is None else build
        self.errs, self.ratios, self.shapes = [], [], set()

    def __call__(self, binned, slot, ch, M: int, B: int):
        k = self.build(binned, slot, ch, M, B)
        p = gk.seg_level_hists_plain(binned, slot, ch, M, B)
        mag = gk.seg_level_hists_plain(binned, slot, ch.abs(), M, B)
        diff = (k - p).abs()
        self.errs.append(diff.max())
        self.ratios.append((diff / (ATOL + RTOL * mag)).max())
        self.shapes.add((binned.shape[0], binned.shape[1], M))
        return k

    def summary(self) -> dict:
        shapes = sorted(self.shapes)
        return {"levels": len(self.errs),
                "max_abs_err": float(torch.stack(self.errs).max()),
                "tol_ratio": float(torch.stack(self.ratios).max()),
                "N": sorted({n for n, _, _ in shapes}),
                "d": sorted({d for _, d, _ in shapes}),
                "M_max": max(m for _, _, m in shapes)}


def _tree_paths_vs_plain(X: torch.Tensor, y: np.ndarray) -> dict:
    """The regression phase's three tree paths grown on its checked
    matrix, every level's histograms held against the plain version
    (``_LevelCheck``): CHECK_ROUNDS rounds of the GBT group's chains
    (depths 3, 6, 12 on the first fold's weights), CHECK_ROUNDS rounds of
    the deep fit's chain (depth 12, GOSS row samples) and CHECK_TREES
    trees of a regression forest (depth 12, one-third subsets, min
    instances 10, bag mode "bagged")."""
    dev = X.device
    n = X.shape[0]
    edges = gk.quantile_bins(X, 32)
    binned = gk.apply_bins(X, edges)
    yt = torch.from_numpy(y).to(dev)
    fold = torch.from_numpy(
        (make_folds(n, 3, seed=42) != 0).astype(np.float32)).to(dev)
    mean = float((fold * yt).sum() / fold.sum())
    out = {}
    runs = {
        "gbt_chains": ([OpGBTRegressor(max_depth=dd, max_iter=CHECK_ROUNDS)
                        for dd in (3, 6, 12)], fold),
        "deep_goss": ([OpGBTRegressor(max_depth=DEEP_DEPTH,
                                      max_iter=CHECK_ROUNDS)],
                      torch.ones(n, device=dev))}
    for name, (ests, w) in runs.items():
        chk = _LevelCheck()
        grown = boost_chains(ests, binned, edges, yt,
                             w[None].repeat(len(ests), 1),
                             torch.full((len(ests),), mean), [],
                             hist_fn=chk)
        out[name] = {**chk.summary(), "goss": grown.goss,
                     "splits": sum(int((t.thresh < 32).sum())
                                   for c in grown.trees for t in c)}
    chk = _LevelCheck()
    forest = gk.grow_rf_grid(
        binned, yt, fold[None], seed=7, n_trees=CHECK_TREES, pair_fold=[0],
        pair_min_ig=[0.001], pair_min_inst=[10], pair_depth=[12],
        msub=X.shape[1] // 3, subsample_rate=1.0, n_bins=32,
        regression=True, hist_fn=chk)
    out["rf_reg"] = {**chk.summary(),
                     "splits": int((forest.thresh < 32).sum())}
    return out


def _checked_matrix(model, checked, data) -> torch.Tensor:
    """The fitted vectorizers' and checker's matrix of ``data``."""
    stage_map = {s.uid: s for s in model.stages}
    dag = compute_dag([checked.copy_with_new_stages(stage_map)])
    return transform_dag(dag, data, keep=[checked.name])[checked.name].values


def phase_regression(data, cols: int) -> dict:
    """The default regression selector on the slice's columns plus an
    Integral and a PickList, a new label; save/load/local scoring of the
    trained model; one deep GBT fit that grows on GOSS row samples."""
    rtrain, rhold, max_r2, data_s = make_regression_data(data)
    rows, holdout = len(rtrain), len(rhold)
    label = FeatureBuilder.RealNN("label").as_response()
    preds = ([FeatureBuilder.Real(f"f{j}").as_predictor()
              for j in range(cols)]
             + [FeatureBuilder.Integral("rad").as_predictor(),
                FeatureBuilder.PickList("chas").as_predictor()])
    checked = label.transform_with(SanityChecker(max_correlation=0.99),
                                   transmogrify(preds))
    selector = RegressionModelSelector.with_cross_validation()
    pred = label.transform_with(selector, checked)
    wf = OpWorkflow().set_result_features(pred).set_input_data(rtrain)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gk.seg_level_hists.launches = 0
    t0 = time.perf_counter()
    model = wf.train()
    train_s = time.perf_counter() - t0
    launches = gk.seg_level_hists.launches
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    scored, metrics = model.score_and_evaluate(
        Evaluators.Regression.rmse(), data=rhold)
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    prediction = scored[pred.name].values.prediction
    meta = selector.metadata
    summary = meta["model_selector_summary"]
    results = summary["validationResults"]

    # save -> load on the card -> the holdout bitwise; the local scorer
    tmp = os.path.join(REPO, "smoke_out")
    path = os.path.join(tmp, "regression")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        t0 = time.perf_counter()
        model.save(path)
        save_s = time.perf_counter() - t0
        nbytes = _dir_bytes(path)
        t0 = time.perf_counter()
        loaded = OpWorkflowModel.load(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    reloaded = loaded.score(rhold)[pred.name].values.prediction
    bitwise = bool(torch.equal(reloaded, prediction))
    names = [f"f{j}" for j in range(cols)] + ["rad", "chas"]
    local_rows = _regression_rows(rhold, names, 64)
    local = [r[pred.name]["prediction"]
             for r in score_function_batch(loaded)(local_rows)]
    batch64 = loaded.score(rhold.slice(0, 64))[pred.name].values.prediction
    local_equal = local == batch64.cpu().tolist()

    # one deep boosted fit on the checked matrix: GOSS row samples
    X = model.train_data[checked.name].values
    y = np.asarray(rtrain["label"].values, np.float32)
    est = OpGBTRegressor(max_depth=DEEP_DEPTH, max_iter=DEEP_ROUNDS)
    torch.cuda.synchronize()
    gk.seg_level_hists.launches = 0
    t0 = time.perf_counter()
    deep_model = est.fit_raw(X, y)
    torch.cuda.synchronize()
    deep_s = time.perf_counter() - t0
    deep_launches = gk.seg_level_hists.launches
    timing = est.metadata["fit_timing"]
    y_hold = torch.as_tensor(np.asarray(rhold["label"].values, np.float32),
                             device=X.device)
    deep_pred = deep_model.predict_values(
        _checked_matrix(model, checked, rhold))
    deep_r2 = float(1 - ((deep_pred - y_hold) ** 2).sum()
                    / ((y_hold - y_hold.mean()) ** 2).sum())
    paths = _tree_paths_vs_plain(X, y)
    deep = {"max_depth": DEEP_DEPTH, "max_iter": DEEP_ROUNDS,
            "rows": int(X.shape[0]), "cols": int(X.shape[1]),
            "goss": est.metadata["goss"], "fit_s": deep_s,
            "binning_s": timing["binning_s"],
            "boosting_s": timing["boosting_s"],
            "rounds_grown": est.metadata["rounds_grown"],
            "ms_per_round": timing["boosting_s"]
            / est.metadata["rounds_grown"] * 1e3,
            "seg_hist_launches": deep_launches,
            "growers_hist_levels": est.metadata["hist_levels"],
            "holdout_r2": deep_r2, "r2_floor": DEEP_R2_FLOOR}
    checked_cols = int(X.shape[1])
    del X, deep_model, deep_pred

    r2 = float(metrics["R2"])
    out = {"phase": "regression", "rows": rows, "holdout": holdout,
           "predictors": cols + 2, "folds": selector.validator.num_folds,
           "label_noise_var": REG_NOISE_VAR, "max_attainable_r2": max_r2,
           "r2_floor": R2_FLOOR, "data_s": data_s, "train_s": train_s,
           "score_s": score_s, "stage_seconds": model.stage_seconds,
           "sweep_seconds": meta["sweep_seconds"],
           "group_errors": meta["group_errors"],
           "tree_phase_seconds": meta["tree_phase_seconds"],
           "refit_seconds": meta["refit_seconds"],
           "metrics_seconds": meta["metrics_seconds"],
           "winner": summary["bestModelType"],
           "winner_params": summary["bestModelParams"],
           "cv": [{"model": r["modelType"], "params": r["params"],
                   "rmse": r["metricValue"], "error": r.get("error")}
                  for r in results],
           "train_metrics": summary["trainEvaluationMetrics"],
           "holdout_metrics": metrics,
           "trees_grown": meta["rf_trees"], "group_trees": meta[
               "group_trees"], "group_hist_levels": meta["group_hist_levels"],
           "seg_hist_launches": launches,
           "growers_hist_levels": meta["hist_levels"],
           "max_memory_allocated": peak,
           "dropped_columns": len(checked.origin_stage.metadata["summary"]
                                  ["dropped"]),
           "save_s": save_s, "load_s": load_s, "artifact_bytes": nbytes,
           "holdout_bitwise_after_load": bitwise,
           "local_scorer_rows_equal": local_equal, "deep_gbt": deep,
           "checked_cols": checked_cols, "tree_paths_vs_plain": paths,
           "seg_hist_launches_total": launches + deep_launches}
    emit(out)
    check(tuple(prediction.shape) == (holdout,),
          f"prediction shape {tuple(prediction.shape)}")
    check(bool(torch.isfinite(prediction).all()), "non-finite predictions")
    check(len(results) == 29, f"{len(results)} validation results, not 29")
    errors = [r["error"] for r in results if r.get("error")]
    check(not errors, f"candidates failed: {errors}")
    check(not meta["group_errors"],
          f"grid groups failed: {meta['group_errors']}")
    check({"LinRegGridGroup", "RFGridGroup", "GBTGridGroup"}
          <= set(meta["sweep_seconds"]),
          f"grid groups not run: {sorted(meta['sweep_seconds'])}")
    check(launches > 0 and launches == meta["hist_levels"],
          f"seg_hist launches {launches} != the growers' "
          f"{meta['hist_levels']} histogram levels")
    check(r2 >= R2_FLOOR, f"holdout R2 {r2} below the floor {R2_FLOOR}")
    check(bitwise, "regression: holdout predictions after save/load differ")
    check(local_equal, "regression: local scorer rows differ from the "
          "loaded model's batch")
    check(deep["goss"] is not None, "deep GBT fit did not engage GOSS")
    check(deep_launches == deep["growers_hist_levels"]
          == DEEP_DEPTH * deep["rounds_grown"],
          f"deep GBT seg_hist launches {deep_launches} != "
          f"{deep['growers_hist_levels']} levels")
    check(deep_r2 >= DEEP_R2_FLOOR, f"deep GBT holdout R2 {deep_r2} below "
          f"the floor {DEEP_R2_FLOOR}")
    for name, row in paths.items():
        check(row["levels"] > 0 and row["splits"] > 0,
              f"{name}: no level or no split grown")
        check(row["tol_ratio"] <= 1.0, f"{name}: kernel vs plain error "
              f"{row['max_abs_err']} beyond rtol {RTOL} (of the sums of "
              f"|channels|) / atol {ATOL}")
    check(paths["deep_goss"]["goss"] is not None
          and paths["gbt_chains"]["goss"] is None,
          f"GOSS engaged where it should not, or not where it should: "
          f"{paths}")
    return out


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def _pcts(latencies_s) -> dict:
    ms = np.sort(np.asarray(latencies_s)) * 1e3
    return {"p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "mean_ms": float(ms.mean()), "n": len(ms)}


def _request_split(model, rows: list) -> dict:
    """Where one single-row request's time goes on the serving path,
    ``score_function_batch``: each stage's transform, synchronised in the
    scorer's per-stage hook, and the rest of the request (the raw columns
    from the row, the plan's drops, the result's copy to the host)."""
    per_stage = {}

    def on_stage(st, dt):
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        key = type(st).__name__
        per_stage[key] = (per_stage.get(key, 0.0) + dt
                          + time.perf_counter() - t0)

    scorer = score_function_batch(model, on_stage=on_stage)
    total = 0.0
    for r in rows:
        t0 = time.perf_counter()
        scorer([r])
        total += time.perf_counter() - t0
    n = len(rows)
    return {"requests": n, "request_ms": total / n * 1e3,
            "stage_ms": {k: v / n * 1e3 for k, v in per_stage.items()},
            "outside_stages_ms": (total - sum(per_stage.values())) / n * 1e3}


# ---------------------------------------------------------------------------
# the titanic phase: the reference's headline demo at 1M + 100k rows
# ---------------------------------------------------------------------------

#: the demo frame's raw columns and their feature types
TITANIC_SCHEMA = {
    "Survived": ft.RealNN, "Pclass": ft.PickList, "Name": ft.Text,
    "Sex": ft.PickList, "Age": ft.Real, "SibSp": ft.Integral,
    "Parch": ft.Integral, "Ticket": ft.PickList, "Fare": ft.Real,
    "Cabin": ft.PickList, "Embarked": ft.PickList}


def make_titanic(rows: int, seed: int = 7) -> dict:
    """examples/bench_pipeline.py's ``make_titanic_like`` recipe (the same
    draws in the same order) as numpy columns, without pandas: Titanic's
    columns and cardinalities (681 tickets, 147 cabins, 77% missing
    cabins, 20% missing ages), names ``Passenger {i % 5000} von
    Name{i % 97}``, and a label drawn independently of the features."""
    rng = np.random.default_rng(seed)
    cols = {}
    cols["Survived"] = (rng.random(rows) > 0.62).astype(float)
    cols["Pclass"] = rng.choice(["1", "2", "3"], rows, p=[0.24, 0.21, 0.55])
    cols["Name"] = np.array([f"Passenger {i % 5000} von Name{i % 97}"
                             for i in range(rows)], dtype=object)
    cols["Sex"] = rng.choice(["male", "female"], rows, p=[0.65, 0.35])
    cols["Age"] = np.where(rng.random(rows) < 0.2, np.nan,
                           rng.normal(30, 13, rows).clip(0.4, 80))
    cols["SibSp"] = rng.integers(0, 6, rows).astype(float)
    cols["Parch"] = rng.integers(0, 5, rows).astype(float)
    cols["Ticket"] = rng.choice([f"T{i}" for i in range(681)], rows)
    cols["Fare"] = rng.lognormal(3.0, 1.0, rows)
    cols["Cabin"] = np.where(rng.random(rows) < 0.77, None,
                             rng.choice([f"C{i}" for i in range(147)], rows))
    cols["Embarked"] = rng.choice(["S", "C", "Q"], rows,
                                  p=[0.72, 0.19, 0.09])
    return cols


def titanic_columns(n: int):
    """``make_titanic``'s n rows with the label redrawn with signal (see
    ``titanic_data``), and the true probabilities."""
    cols = make_titanic(n)
    logit = (-1.1 + 2.4 * (cols["Sex"] == "female")
             - 1.0 * (cols["Pclass"] == "3")
             + 0.35 * np.log1p(cols["Fare"])
             - 0.015 * np.nan_to_num(cols["Age"], nan=30))
    p = 1 / (1 + np.exp(-logit))
    u = np.random.default_rng(TITANIC_LABEL_SEED).random(n)
    cols["Survived"] = (p > u).astype(float)
    return cols, p


def _depth_cut(tdata, k: int):
    """``titanic_data``'s datasets cut to the first 1/k of the rows and of
    the holdout (views, not copies)."""
    train, hold, p_hold, data_s = tdata
    n, h = len(train) // k, len(hold) // k
    return train.slice(0, n), hold.slice(0, h), p_hold[:h], data_s


def titanic_data(rows: int, holdout: int):
    """The demo's train and holdout datasets, the label regenerated with
    signal (sigmoid(-1.1 + 2.4 [female] - 1.0 [3rd class] + 0.35
    log1p(fare) - 0.015 age, 30 where missing) against uniform draws from
    TITANIC_LABEL_SEED), the holdout's true probabilities and the
    seconds taken."""
    t0 = time.perf_counter()
    n = rows + holdout
    cols, p = titanic_columns(n)

    def ds(lo, hi):
        return ColumnarDataset({
            k: FeatureColumn.from_values(TITANIC_SCHEMA[k], v[lo:hi])
            for k, v in cols.items()})

    train, hold = ds(0, rows), ds(rows, n)
    return train, hold, p[rows:], time.perf_counter() - t0


def build_titanic(extra=(), selector=None):
    """The demo's DAG exactly as examples/op_titanic_simple.py builds it,
    with the port's imports: (prediction, features, checked, selector);
    ``extra`` predictors join its ``transmogrify`` list; ``selector``
    replaces the demo's selector."""
    survived = FeatureBuilder.RealNN("Survived").as_response()
    pclass = FeatureBuilder.PickList("Pclass").as_predictor()
    name = FeatureBuilder.Text("Name").as_predictor()
    sex = FeatureBuilder.PickList("Sex").as_predictor()
    age = FeatureBuilder.Real("Age").as_predictor()
    sibsp = FeatureBuilder.Integral("SibSp").as_predictor()
    parch = FeatureBuilder.Integral("Parch").as_predictor()
    ticket = FeatureBuilder.PickList("Ticket").as_predictor()
    fare = FeatureBuilder.Real("Fare").as_predictor()
    cabin = FeatureBuilder.PickList("Cabin").as_predictor()
    embarked = FeatureBuilder.PickList("Embarked").as_predictor()

    family_size = sibsp + parch + 1.0
    estimated_cost = family_size * fare
    pivoted_sex = sex.vectorize(top_k=2)

    features = transmogrify([pclass, name, age, sibsp, parch, ticket,
                             fare, cabin, embarked, family_size,
                             estimated_cost, pivoted_sex, *extra])
    checked = SanityChecker(remove_bad_features=True).set_input(
        survived, features).get_output()
    selector = selector or \
        BinaryClassificationModelSelector.with_cross_validation(
            num_folds=3,
            models_and_parameters=[
                (OpLogisticRegression(), grid(
                    reg_param=[0.01, 0.1, 0.3], elastic_net_param=[0.0])),
                (OpRandomForestClassifier(), grid(
                    num_trees=[50], max_depth=[6, 12],
                    min_info_gain=[0.001])),
            ],
        )
    prediction = selector.set_input(survived, checked).get_output()
    return prediction, features, checked, selector


class _BitwiseLevels:
    """A ``hist_fn`` that launches the kernel, holds each level bitwise to
    the plain version (integer channels) and keeps the level inputs of
    the most slots for timing."""

    def __init__(self):
        self.levels, self.unequal, self.max_err = 0, 0, 0.0
        self.widest = None

    def __call__(self, binned, slot, ch, M: int, B: int):
        k = gk.seg_level_hists(binned, slot, ch, M, B)
        p = gk.seg_level_hists_plain(binned, slot, ch, M, B)
        self.levels += 1
        self.unequal += int(not torch.equal(k, p))
        self.max_err = max(self.max_err, float((k - p).abs().max()))
        if self.widest is None or M > self.widest[3]:
            # a copy in the kernel's padded row layout
            b = gk.binned_empty(*binned.shape, binned.device)
            b.copy_(binned)
            self.widest = (b, slot.clone(), ch.clone(), M, B)
        return k


def _titanic_levels(X: torch.Tensor, y: np.ndarray, msub: int, reps: int,
                    bw: float, f32: float) -> dict:
    """TITANIC_CHECK_TREES demo forest trees (depth 12, min info gain 0.001,
    ``msub``-column subsets, the first fold's weights) grown on the
    checked matrix binned as the demo's group bins it, every level held
    bitwise to the plain version, with the count of trees by the levels
    that split (``split_levels_per_tree[k]``: trees whose deepest split
    is on level k - 1); then the level of most slots timed: the kernel,
    the plain version, the library call (two weighted
    ``torch.bincount``) and the bound."""
    dev = X.device
    edges, binned = prep_tree_inputs(X, 32)
    fold = torch.from_numpy(
        (make_folds(X.shape[0], 3, seed=42) != 0).astype(np.float32)).to(dev)
    chk = _BitwiseLevels()
    forest = gk.grow_rf_grid(
        binned, torch.from_numpy(y).to(dev), fold[None], seed=42,
        n_trees=TITANIC_CHECK_TREES, pair_fold=[0], pair_min_ig=[0.001],
        pair_min_inst=[1], pair_depth=[12], msub=msub, subsample_rate=1.0,
        n_bins=32, hist_fn=chk)
    b, slot, ch, M, B = chk.widest
    del binned, chk.widest
    splits = forest.thresh[0] < 32                       # (T, 2^12 - 1)
    level_of = torch.log2(torch.arange(1, splits.shape[1] + 1,
                                       device=dev).double()).floor().long()
    deepest = torch.where(splits, level_of + 1, 0).amax(dim=1)
    split_levels = torch.bincount(deepest.cpu(), minlength=13).tolist()
    n, dd = b.shape
    args = (b, slot, ch, M, B)
    kernel_ms = time_ms(lambda: gk.seg_level_hists(*args), reps)
    plain_ms = time_ms(lambda: gk.seg_level_hists_plain(*args), 3, 1)
    library_ms = _library_ms(b, slot, ch, M, B)
    nbytes = n * dd + n * 4 + n * 2 * 4 + M * 2 * B * dd * 4
    ops = n * dd * 2
    return {"phase": "seg_hist", "path": "titanic", "N": n, "d": dd, "B": B,
            "nchan": 2, "M": M, "row_stride": b.stride(0),
            "trees": TITANIC_CHECK_TREES, "levels_checked": chk.levels,
            "levels_unequal": chk.unequal, "max_abs_err": chk.max_err,
            "bitwise_equal": chk.unequal == 0,
            "splits": int((forest.thresh < 32).sum()),
            "split_levels_per_tree": split_levels,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "bound_ms": max(nbytes / bw, ops / f32) * 1e3,
            "bound_by": "bytes" if nbytes / bw >= ops / f32
            else "operations", "bytes": nbytes}


def _titanic_rows(hold, k: int) -> list:
    """The first ``k`` holdout rows as a client sends them: raw values by
    feature name, missing ones as None, no label."""
    names = [nm for nm in TITANIC_SCHEMA if nm != "Survived"]
    return _regression_rows(hold, names, k)


def phase_titanic(tdata, reps: int, bw: float, f32: float, smem_bw: float):
    """The reference's headline demo on the card: train, the sketch it
    took, holdout AuPR against the attainable, the kernel on the demo's
    own levels, save/load, the local scorer and single-row serving.
    ``tdata`` is ``titanic_data``'s."""
    train, hold, p_hold, data_s = tdata
    rows, holdout = len(train), len(hold)
    pred, features, checked, selector = build_titanic()
    wf = OpWorkflow().set_result_features(pred).set_input_data(train)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kinds = dict(SKETCH_KINDS)
    gk.seg_level_hists.launches = 0
    t0 = time.perf_counter()
    model = wf.train()
    train_s = time.perf_counter() - t0
    launches = gk.seg_level_hists.launches
    peak = torch.cuda.max_memory_allocated()
    kinds = {k: SKETCH_KINDS[k] - kinds[k] for k in kinds}
    # the training transform's split, before scoring transforms again
    smart = next(s for s in model.stages
                 if isinstance(s, SmartTextVectorizerModel))
    smart_transform_s = dict(smart.transform_seconds)
    t0 = time.perf_counter()
    scored, metrics = model.score_and_evaluate(
        Evaluators.BinaryClassification.auPR(), data=hold)
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    proba = scored[pred.name].values.probability
    y_hold = torch.as_tensor(np.asarray(hold["Survived"].values,
                                        np.float32))
    attainable = aupr(y_hold, torch.from_numpy(p_hold.astype(np.float32)))
    aupr_hold = float(metrics["AuPR"])

    meta = selector.metadata
    summary = meta["model_selector_summary"]
    results = summary["validationResults"]
    smart_est = next(f.origin_stage for f in features.parents
                     if isinstance(f.origin_stage, SmartTextVectorizer))
    secs = model.stage_seconds
    vec_stages = ("RealVectorizer", "IntegralVectorizer", "OneHotVectorizer",
                  "SmartTextVectorizer", "VectorsCombiner")
    d_before = int(model.train_data[features.name].values.shape[1])
    X = model.train_data[checked.name].values
    d_after = int(X.shape[1])
    msub = int(np.sqrt(d_after))
    y = np.asarray(train["Survived"].values, np.float32)
    kernel_row = _titanic_levels(X, y, msub, reps, bw, f32)
    Xh = _checked_matrix(model, checked, hold)
    efb = _efb_line(X, y, Xh, y_hold, reps, bw, f32, smem_bw)
    del X, Xh
    pivot = pivot_checks(model, hold, "titanic")

    # save -> load on the card -> the holdout bitwise; the local scorer
    tmp = os.path.join(REPO, "smoke_out")
    path = os.path.join(tmp, "titanic")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    req = _titanic_rows(hold, SEQ_REQUESTS)
    try:
        t0 = time.perf_counter()
        model.save(path)
        save_s = time.perf_counter() - t0
        nbytes = _dir_bytes(path)
        t0 = time.perf_counter()
        loaded = OpWorkflowModel.load(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        reloaded = loaded.score(hold)[pred.name].values.probability
        bitwise = bool(torch.equal(reloaded, proba))
        local = [r[pred.name]["probability_1"]
                 for r in score_function_batch(loaded)(req[:64])]
        batch64 = loaded.score(hold.slice(0, 64))[pred.name] \
            .values.probability[:, 1]
        local_equal = local == batch64.cpu().tolist()
        split = _request_split(loaded, req[:SPLIT_REQUESTS])
        lat, served = [], []
        with ModelServer.from_path(path, name="titanic", max_batch=64,
                                   warmup_row=req[0]) as srv:
            for r in req[:TITANIC_SERVE_REQUESTS]:
                t = time.perf_counter()
                out = srv.score([r])
                lat.append(time.perf_counter() - t)
                served.append(out[0][pred.name]["probability_1"])
            snap = srv.snapshot()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    served_diff = float(np.abs(np.asarray(served) - proba[
        :len(served), 1].cpu().numpy().astype(np.float64)).max())

    out = {"phase": "titanic", "rows": rows, "holdout": holdout,
           "data_s": data_s, "train_s": train_s, "score_s": score_s,
           "stage_seconds": secs,
           "smart_text_fit_s": smart_est.fit_seconds,
           "smart_text_transform_s": smart_transform_s,
           "transmogrify_s": sum(secs.get(k, 0.0) for k in vec_stages),
           "feature_arithmetic_s": sum(
               secs.get(k, 0.0) for k in ("MathBinaryTransformer",
                                          "MathScalarTransformer")),
           "sanity_checker_s": secs.get("SanityChecker"),
           "text_strategies": smart.metadata.get("text_strategies"),
           "sketch_kinds": kinds, "d_before_checker": d_before,
           "d_after_checker": d_after, "rf_subset_width": msub,
           "winner": summary["bestModelType"],
           "winner_params": summary["bestModelParams"],
           "cv": [{"model": r["modelType"], "params": r["params"],
                   "metric": r["metricValue"], "folds": r["foldValues"],
                   "error": r.get("error")} for r in results],
           "sweep_seconds": meta["sweep_seconds"],
           "tree_phase_seconds": meta["tree_phase_seconds"],
           "group_errors": meta["group_errors"],
           "holdout_aupr": aupr_hold, "attainable_aupr": attainable,
           "aupr_floor": TITANIC_AUPR_SHARE * attainable,
           "holdout_metrics": metrics, "rf_trees": meta["rf_trees"],
           "seg_hist_launches": launches,
           "growers_hist_levels": meta["hist_levels"],
           "max_memory_allocated": peak,
           "dropped_columns": len(checked.origin_stage.metadata["summary"]
                                  ["dropped"]),
           "save_s": save_s, "load_s": load_s, "artifact_bytes": nbytes,
           "holdout_bitwise_after_load": bitwise,
           "local_scorer_rows_equal": local_equal,
           "request_split": split,
           "serve_batch1": _pcts(lat), "served_max_abs_diff": served_diff,
           "server_shed": snap["shed"],
           "server_device_errors": snap["deviceErrors"],
           "efb_launches": efb["launches_total"],
           "pivot_stages": [x["stage"] for x in pivot["stages"]]}
    emit(out)
    emit(kernel_row)
    check(tuple(proba.shape) == (holdout, 2), f"proba shape {proba.shape}")
    check(bool(torch.isfinite(proba).all()), "non-finite probabilities")
    check(len(results) == 5, f"{len(results)} validation results, not 5")
    errors = [r["error"] for r in results if r.get("error")]
    check(not errors, f"candidates failed: {errors}")
    check(not meta["group_errors"],
          f"grid groups failed: {meta['group_errors']}")
    check({"LogRegGridGroup", "RFGridGroup"} <= set(meta["sweep_seconds"]),
          f"grid groups not run: {sorted(meta['sweep_seconds'])}")
    check(kinds["sparse_aware"] > 0 and kinds["dense"] == 0,
          f"titanic: the tree prep took the sketches {kinds}, not the "
          f"nonzero-aware one")
    check(launches > 0 and launches == meta["hist_levels"],
          f"seg_hist launches {launches} != the growers' "
          f"{meta['hist_levels']} histogram levels")
    check(aupr_hold >= TITANIC_AUPR_SHARE * attainable,
          f"titanic: holdout AuPR {aupr_hold} below {TITANIC_AUPR_SHARE} x "
          f"the attainable {attainable}")
    check(kernel_row["bitwise_equal"] and kernel_row["levels_checked"] > 0,
          f"titanic: {kernel_row['levels_unequal']} of "
          f"{kernel_row['levels_checked']} levels differ from the plain "
          f"version by up to {kernel_row['max_abs_err']}")
    check(bitwise, "titanic: holdout scores after save/load differ")
    check(local_equal, "titanic: local scorer rows differ from the loaded "
          "model's batch")
    check(served_diff <= 1e-6 and snap["shed"] == 0
          and snap["deviceErrors"] == 0,
          f"titanic: served scores {served_diff} from the in-memory "
          f"model's, shed {snap['shed']}, device errors "
          f"{snap['deviceErrors']}")
    return out


# ---------------------------------------------------------------------------
# the validate_explain phase: the DAG lint, RawFeatureFilter, ModelInsights,
# RecordInsights LOCO and Corr, Spearman
# ---------------------------------------------------------------------------

def _with_planted(ds, rng, fare_scale: float = 1.0):
    """``ds`` with the RawFeatureFilter's two planted raw features: ``leak``
    (null exactly where Survived is 1) and ``rare`` (filled on
    VE_RARE_SHARE of the rows), and Fare scaled by ``fare_scale``."""
    n = len(ds)
    y = np.asarray(ds["Survived"].values)
    leak = np.where(y == 1, np.nan, rng.normal(size=n))
    rare = np.where(rng.random(n) < VE_RARE_SHARE, rng.normal(size=n),
                    np.nan)
    cols = {"leak": FeatureColumn.from_values(ft.Real, leak),
            "rare": FeatureColumn.from_values(ft.Real, rare)}
    if fare_scale != 1.0:
        cols["Fare"] = FeatureColumn.from_values(
            ft.Real, np.asarray(ds["Fare"].values) * fare_scale)
    return ds.with_columns(cols)


def _lint_refusals(train) -> dict:
    """A label wired into a vectorizer (TM006) and an input no stage makes
    (TM001): each train must raise PipelineLintError before it reads any
    data."""
    survived = FeatureBuilder.RealNN("Survived").as_response()
    age = FeatureBuilder.Real("Age").as_predictor()
    leaky = RealVectorizer().set_input(survived, age)
    ghost = Feature(name="ghost", ftype=ft.Real, origin_stage=age.origin_stage,
                    parents=[])
    dangling = RealVectorizer().set_input(ghost)
    out = {}
    for rule, feat in (("TM006", leaky.get_output()),
                       ("TM001", dangling.get_output())):
        wf = OpWorkflow().set_result_features(feat).set_input_data(train)
        reads = []
        inner = wf.reader.generate_dataset
        wf.reader.generate_dataset = lambda fs: reads.append(1) or inner(fs)
        t0 = time.perf_counter()
        try:
            wf.train()
            fired = None
        except PipelineLintError as e:
            fired = e.findings.rules_fired()
        out[rule] = {"raised": fired, "data_reads": len(reads),
                     "s": time.perf_counter() - t0}
        check(fired == [rule] and not reads,
              f"lint: the {rule} pipeline raised {fired} after {len(reads)} "
              f"data reads")
    return out


def _np_spearman(x: np.ndarray, y: np.ndarray) -> float:
    """float64 Spearman correlation: Pearson of the average ranks."""
    def rank(v):
        order = np.argsort(v, kind="stable")
        s = v[order]
        first = np.r_[True, s[1:] != s[:-1]]
        gid = np.cumsum(first) - 1
        starts = np.flatnonzero(first)
        ends = np.r_[starts[1:], len(v)] - 1
        r = np.empty(len(v))
        r[order] = (starts[gid] + ends[gid]) / 2.0 + 1.0
        return r
    rx, ry = rank(x), rank(y)
    rx -= rx.mean()
    ry -= ry.mean()
    return float(rx @ ry / np.sqrt((rx @ rx) * (ry @ ry)))


def _device_matrix(ds, names, dev="cuda") -> torch.Tensor:
    """Columns ``names`` of a host dataset as one contiguous float32 (N, d)
    matrix on ``dev``, VE_STACK_COLS at a time: each block stacked as
    contiguous host rows (a column-interleaved host stack costs several
    times the copy) and transposed on the device."""
    X = torch.empty((len(ds), len(names)), dtype=torch.float32, device=dev)
    for a in range(0, len(names), VE_STACK_COLS):
        blk = np.stack([np.asarray(ds[n].values, np.float32)
                        for n in names[a:a + VE_STACK_COLS]])
        X[:, a:a + len(blk)] = torch.from_numpy(blk).to(dev).T
    return X


def phase_validate_explain(tdata, data, xgb, cols: int) -> dict:
    """The validation-and-explanation path on the card (the module
    docstring's phase 6b)."""
    train, hold, p_hold, _ = tdata
    rng = np.random.default_rng(VE_SEED)
    phase_t0 = time.perf_counter()
    t0 = time.perf_counter()
    train_p = _with_planted(train, rng)
    hold_p = _with_planted(hold, rng)
    score_p = _with_planted(hold, rng, fare_scale=VE_FARE_SCALE)
    data_s = time.perf_counter() - t0

    pred, features, checked, selector = build_titanic(extra=(
        FeatureBuilder.Real("leak").as_predictor(),
        FeatureBuilder.Real("rare").as_predictor()))
    wf = (OpWorkflow().set_result_features(pred).set_input_data(train_p)
          .with_raw_feature_filter(scoring_data=score_p))
    torch.cuda.synchronize()
    gk.seg_level_hists.launches = 0
    t0 = time.perf_counter()
    model = wf.train()
    train_s = time.perf_counter() - t0
    launches = gk.seg_level_hists.launches
    rff = model.raw_feature_filter_results
    score_by = {(d.name, d.key): d for d in rff.score_distributions}
    js = {d.full_name: d.js_divergence(score_by[(d.name, d.key)])
          for d in rff.train_distributions if (d.name, d.key) in score_by}
    leftover = sorted({n for s in model.stages for n in s.input_names}
                      & {"leak", "rare"})
    scored, metrics = model.score_and_evaluate(
        Evaluators.BinaryClassification.auPR(), data=hold_p)
    y_hold = torch.as_tensor(np.asarray(hold["Survived"].values, np.float32))
    attainable = aupr(y_hold, torch.from_numpy(p_hold.astype(np.float32)))
    aupr_hold = float(metrics["AuPR"])

    t0 = time.perf_counter()
    insights = model.model_insights()
    doc = json.dumps(insights.to_json(), default=str)
    insights_s = time.perf_counter() - t0

    # record insights on the holdout's checked vectors
    t0 = time.perf_counter()
    full = model.score(hold_p, keep_intermediate_features=True,
                       keep_raw_features=True)
    vec, pcol = full[checked.name], full[pred.name]
    torch.cuda.synchronize()
    vec_s = time.perf_counter() - t0
    selected = next(s for s in model.stages
                    if "model_selector_summary" in s.metadata)
    loco_col = FeatureColumn(vec.ftype, vec.values[:VE_LOCO_ROWS],
                             vmeta=vec.vmeta)
    loco = RecordInsightsLOCO(selected, top_k=20)
    t0 = time.perf_counter()
    loco_out = loco.transform_columns(loco_col).values
    torch.cuda.synchronize()
    loco_s = time.perf_counter() - t0
    loco_first = parse_insights(loco_out[0])
    corr = {}
    for kind in ("pearson", "spearman"):
        t0 = time.perf_counter()
        fitted = RecordInsightsCorr(correlation_type=kind).fit_columns(
            None, pcol, vec)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rows_out = fitted.transform_columns(pcol, vec).values
        corr[kind] = {"fit_s": fit_s, "transform_s": time.perf_counter() - t0,
                      "rows": len(rows_out),
                      "keys_row0": len(rows_out[0]),
                      "finite": bool(np.isfinite(fitted.score_corr).all())}
    del full, vec, pcol, loco_col

    # save -> load keeps rawFeatureFilterResults
    tmp = os.path.join(REPO, "smoke_out")
    shutil.rmtree(tmp, ignore_errors=True)
    try:
        model.save(os.path.join(tmp, "rff"))
        loaded = OpWorkflowModel.load(os.path.join(tmp, "rff"))
        kept = (json.dumps(loaded.raw_feature_filter_results, sort_keys=True)
                == json.dumps(rff.to_json(), sort_keys=True))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    snap = model.lint_snapshot
    out = {"phase": "validate_explain", "rows": len(train),
           "holdout": len(hold), "data_s": data_s, "train_s": train_s,
           "stage_seconds": model.stage_seconds,
           "lint_s": snap.wall_s, "lint_rule_counts": snap.rule_counts,
           "rff_s": model.raw_feature_filter_seconds,
           "rff_profile_s": rff.profile_seconds,
           "dropped": rff.dropped_features,
           "dropped_map_keys": rff.dropped_map_keys,
           "js_divergence": js,
           "leak_null_label_corr": next(
               d.null_label_corr() for d in rff.train_distributions
               if d.name == "leak"),
           "rare_fill_rate": next(d.fill_rate() for d in
                                  rff.train_distributions
                                  if d.name == "rare"),
           "holdout_aupr": aupr_hold, "attainable_aupr": attainable,
           "aupr_floor": TITANIC_AUPR_SHARE * attainable,
           "winner": selector.metadata["model_selector_summary"][
               "bestModelType"],
           "seg_hist_launches": launches,
           "growers_hist_levels": selector.metadata["hist_levels"],
           "insights_s": insights_s, "insights_json_bytes": len(doc),
           "insights_top5": insights.top_contributions(5),
           "holdout_vectors_s": vec_s,
           "loco_rows": VE_LOCO_ROWS, "loco_slots": loco.slots_scored,
           "loco_s": loco_s, "loco_rows_per_s": VE_LOCO_ROWS / loco_s,
           "loco_row0_top": list(loco_first)[:5],
           "corr": corr, "rff_results_kept_after_load": kept,
           "part_s": time.perf_counter() - phase_t0}
    emit(out)
    check(rff.dropped_features == ["leak", "rare"],
          f"validate_explain: RawFeatureFilter dropped "
          f"{rff.dropped_features}, not ['leak', 'rare']")
    check(js.get("Fare", 1.0) < 0.9, f"validate_explain: Fare's JS "
          f"divergence {js.get('Fare')} (it must be kept)")
    check(not leftover, f"validate_explain: fitted stages still read "
          f"{leftover}")
    check(launches > 0 and launches == selector.metadata["hist_levels"],
          f"validate_explain: seg_hist launches {launches} != the growers' "
          f"{selector.metadata['hist_levels']}")
    check(aupr_hold >= TITANIC_AUPR_SHARE * attainable,
          f"validate_explain: holdout AuPR {aupr_hold} below "
          f"{TITANIC_AUPR_SHARE} x the attainable {attainable}")
    check(len(loco_out) == VE_LOCO_ROWS and 0 < len(loco_first) <= 20
          and all(np.isfinite(v).all() for v in loco_first.values()),
          "validate_explain: LOCO rows malformed")
    check(all(c["rows"] == len(hold) and c["finite"] for c in corr.values()),
          f"validate_explain: RecordInsightsCorr {corr}")
    check(kept, "validate_explain: rawFeatureFilterResults changed in a "
          "save/load round trip")
    check(snap.rule_counts == {}, f"validate_explain: lint findings "
          f"{snap.rule_counts} on the demo's DAG")
    del model, loaded

    emit({"phase": "validate_explain.lint_refusals",
          **_lint_refusals(train)})
    out["launches_total"] = launches
    out.update(_numeric_rff(data, cols))
    out.update(_spearman_and_loco(data, xgb, cols))
    emit({"phase": "validate_explain.total",
          "phase_s": time.perf_counter() - phase_t0})
    return out


def _numeric_rff(data, cols: int) -> dict:
    """RawFeatureFilter's numeric profile of the slice's 1M + 100k x 500
    Real matrix on the card; VE_CHECK_COLS random columns' bins held
    bitwise to the host numpy histogram of the same values."""
    train, hold, _ = data
    raw = [FeatureBuilder.Real(f"f{j}").as_predictor() for j in range(cols)]
    raw.append(FeatureBuilder.RealNN("label").as_response())
    rff = RawFeatureFilter(scoring_data=hold)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, res = rff.filter_raw_data(train, raw, device="cuda")
    profile_s = time.perf_counter() - t0
    picks = np.random.default_rng(VE_SEED).choice(cols, VE_CHECK_COLS,
                                                  replace=False)
    t0 = time.perf_counter()

    def differs(j):
        d = res.train_distributions[j]
        h = StreamingHistogram(100).update(np.asarray(train[f"f{j}"].values))
        return not (np.array_equal(d.hist.centroids, h.centroids)
                    and np.array_equal(d.hist.counts, h.counts))

    with ThreadPoolExecutor(VE_HOST_THREADS) as pool:
        unequal = [int(j) for j, bad in zip(picks, pool.map(differs, picks))
                   if bad]
    host_s = time.perf_counter() - t0
    out = {"phase": "validate_explain.rff_numeric", "rows": len(train),
           "score_rows": len(hold), "cols": cols, "profile_s": profile_s,
           "profile_split_s": res.profile_seconds,
           "dropped": res.dropped_features,
           "max_js": max(d.js_divergence(s) for d, s in zip(
               res.train_distributions, res.score_distributions)),
           "checked_cols": len(picks), "unequal_cols": unequal,
           "host_numpy_s_for_checked": host_s,
           "bins": len(res.train_distributions[0].hist.counts)}
    emit(out)
    check(not unequal, f"rff_numeric: columns {unequal} differ from the "
          f"host histograms")
    check(res.dropped_features == [], f"rff_numeric: dropped "
          f"{res.dropped_features} of clean columns")
    return {"rff_numeric_s": profile_s}


def _spearman_and_loco(data, xgb, cols: int) -> dict:
    """The Spearman SanityChecker on the slice's 1M x 500 matrix (50
    columns held within 1e-5 of float64 numpy), and LOCO through the
    slice's boosted model on VE_XGB_LOCO_ROWS holdout rows."""
    train, hold, _ = data
    names = [f"f{j}" for j in range(cols)]
    X = _device_matrix(train, names)
    y = np.asarray(train["label"].values)
    checker = SanityChecker(correlation_type="spearman",
                            max_correlation=0.99)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checker.fit_columns(None, train["label"],
                        FeatureColumn(ft.OPVector, X))
    torch.cuda.synchronize()
    spearman_s = time.perf_counter() - t0
    stats = checker.metadata["summary"]["columnStats"]
    k = min(VE_SPEARMAN_CHECK, cols)
    Xh = X[:, :k].cpu().numpy()
    del X
    t0 = time.perf_counter()

    def gap(j):
        return abs(stats[j]["corr_label"]
                   - _np_spearman(Xh[:, j].astype(np.float64), y))

    with ThreadPoolExecutor(VE_HOST_THREADS) as pool:
        diff = max(pool.map(gap, range(k)))
    numpy_s = time.perf_counter() - t0

    model, pred = xgb["model"], xgb["pred"]
    tree = pred.origin_stage
    tree = next(s for s in model.stages if s.uid == tree.uid)
    vec_name = tree.input_features[1].name
    part = hold.slice(0, VE_XGB_LOCO_ROWS)
    vec = model.score(part, keep_intermediate_features=True,
                       keep_raw_features=True)[vec_name]
    loco = RecordInsightsLOCO(tree, top_k=20)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = loco.transform_columns(vec).values
    torch.cuda.synchronize()
    loco_s = time.perf_counter() - t0
    out = {"phase": "validate_explain.spearman_loco", "rows": len(train),
           "cols": cols, "spearman_checker_s": spearman_s,
           "spearman_checked_cols": k,
           "spearman_max_abs_diff_vs_numpy_f64": diff,
           "numpy_s_for_checked": numpy_s,
           "spearman_dropped": len(checker.metadata["summary"]["dropped"]),
           "xgb_loco_rows": VE_XGB_LOCO_ROWS,
           "xgb_loco_slots": loco.slots_scored,
           "xgb_loco_s": loco_s, "xgb_loco_rows_per_s": len(rows) / loco_s}
    emit(out)
    check(diff <= 1e-5, f"spearman: {diff} from float64 numpy")
    check(len(rows) == VE_XGB_LOCO_ROWS and all(len(r) > 0 for r in rows),
          "xgb LOCO rows malformed")
    return {"spearman_s": spearman_s, "xgb_loco_s": loco_s}


# ---------------------------------------------------------------------------
# the feature_eng phase: the rest of feature engineering at 1M + 100k rows
# ---------------------------------------------------------------------------

def feature_eng_columns(n: int, seed: int = FE_SEED) -> dict:
    """The phase's extra raw columns, drawn from ``default_rng(seed)``:
    Email (10% null, 5% malformed), EmailMap ({"primary": Email} where it
    is present), Phone (US ten-digit 60%, +44 numbers 20%, invalid
    strings 10%, null 10%), Bio (4-12 words of FE_BIO_WORDS; 2% Cyrillic
    or CJK text), Boarded (epoch ms over two years from 2023-01-01) and
    TicketText (filled in by ``feature_eng_data``)."""
    rng = np.random.default_rng(seed)
    first = np.array(["john", "mary", "anna", "luis", "wei", "olga", "sam",
                      "ines", "karl", "yuki"], dtype=object)
    domains = np.array(["example.com", "mail.example.org", "post.example.de",
                        "correo.example.es"], dtype=object)
    u = rng.random(n)
    fi = rng.integers(0, len(first), n)
    num = rng.integers(0, 10_000, n)
    di = rng.integers(0, len(domains), n)
    email = [None if u[i] < 0.10 else
             (f"{first[fi[i]]}{num[i]}" + ("@" if u[i] >= 0.15 else ".at.")
              + domains[di[i]]) for i in range(n)]
    kind = rng.random(n)
    area = rng.integers(200, 1000, n)
    exch = rng.integers(200, 1000, n)
    line = rng.integers(0, 10_000, n)
    uk = rng.integers(10_000_000, 100_000_000, n)
    phone = [None if kind[i] < 0.10 else
             f"({area[i]}) {exch[i]}-{line[i]:04d}" if kind[i] < 0.70 else
             f"+44 20 {uk[i] // 10_000} {uk[i] % 10_000:04d}"
             if kind[i] < 0.90 else f"{line[i] % 1000}-x{area[i]}"
             for i in range(n)]
    words = np.array(FE_BIO_WORDS, dtype=object)
    lens = rng.integers(4, 13, n)
    idx = rng.integers(0, len(words), (n, 12))
    other = rng.random(n) < 0.02
    oi = rng.integers(0, len(FE_OTHER_SCRIPTS), n)
    bio = [FE_OTHER_SCRIPTS[oi[i]] if other[i] else
           " ".join(words[idx[i, :lens[i]]]) for i in range(n)]
    start = 1_672_531_200_000                  # 2023-01-01T00:00:00Z
    boarded = start + rng.integers(0, 2 * 365 * 86_400_000, n)
    return {"Email": email,
            "EmailMap": [None if e is None else {"primary": e}
                         for e in email],
            "Phone": phone, "Bio": bio, "Boarded": boarded.astype(float)}


FE_SCHEMA = {"Email": ft.Email, "EmailMap": ft.EmailMap, "Phone": ft.Phone,
             "Bio": ft.Text, "Boarded": ft.Date, "TicketText": ft.Text}


def feature_eng_data(train, hold):
    """The titanic phase's datasets with the feature_eng columns (drawn
    for train and holdout rows in one call) and TicketText (the Ticket
    values as Text); the seconds taken."""
    t0 = time.perf_counter()
    n = len(train)
    cols = feature_eng_columns(n + len(hold))
    out = []
    for ds, lo, hi in ((train, 0, n), (hold, n, n + len(hold))):
        extra = {k: FeatureColumn.from_values(FE_SCHEMA[k], v[lo:hi])
                 for k, v in cols.items()}
        extra["TicketText"] = FeatureColumn(ft.Text, ds["Ticket"].values)
        out.append(ds.with_columns(extra))
    return out[0], out[1], time.perf_counter() - t0


def feature_eng_stages() -> dict:
    """The port's entry points the feature_eng DAG is built from (the
    tests pass the JAX package's under the same keys)."""
    from transmogrifai_tpu_torch.ops.detectors import (
        EmailToPickListMapTransformer, IsValidPhoneDefaultCountry,
        LangDetector, ValidEmailTransformer)
    from transmogrifai_tpu_torch.ops.text import OpCountVectorizer
    from transmogrifai_tpu_torch.ops.vectorizers import VectorsCombiner
    from transmogrifai_tpu_torch.preparators.sanity_checker import \
        MinVarianceFilter

    return dict(fb=FeatureBuilder, transmogrify=transmogrify,
                count_vectorizer=OpCountVectorizer,
                valid_email=ValidEmailTransformer,
                email_domains=EmailToPickListMapTransformer,
                valid_phone=IsValidPhoneDefaultCountry, lang=LangDetector,
                combiner=VectorsCombiner, min_variance=MinVarianceFilter,
                checker=SanityChecker,
                selector=BinaryClassificationModelSelector)


def build_feature_eng(pkg: dict, models_and_parameters=None):
    """The feature_eng DAG: the Titanic demo's raw columns and the four
    extra ones through the fluent DSL and the feature-engineering stages,
    then VectorsCombiner -> MinVarianceFilter -> SanityChecker -> the
    binary selector (its default grid unless ``models_and_parameters``).
    ``pkg`` names the entry points (``feature_eng_stages``):
    (prediction, {name: feature}, selector)."""
    fb = pkg["fb"]
    survived = fb.RealNN("Survived").as_response()
    raw = [fb.PickList(k).as_predictor()
           for k in ("Pclass", "Sex", "Cabin", "Embarked")]
    raw += [fb.Integral(k).as_predictor() for k in ("SibSp", "Parch")]
    name = fb.Text("Name").as_predictor()
    age = fb.Real("Age").as_predictor()
    fare = fb.Real("Fare").as_predictor()
    bio = fb.Text("Bio").as_predictor()

    def stage(key, *inputs, **kw):
        return pkg[key](**kw).set_input(*inputs).get_output()

    name_tokens = name.tokenize()
    f = {
        "name_tf": name_tokens.remove_stop_words().ngrams()
        .hashing_tf(num_features=FE_HASH_FEATURES),
        "name_w2v": name_tokens.word2vec(vector_size=FE_W2V_SIZE),
        "bio_counts": stage("count_vectorizer", bio.tokenize(),
                            vocab_size=FE_VOCAB),
        "age_buckets": age.auto_bucketize(
            survived, max_depth=FE_DT_DEPTH, max_bins=FE_DT_BINS,
            min_info_gain=FE_DT_MIN_GAIN),
        "fare_buckets": fare.auto_bucketize(
            survived, max_depth=FE_DT_DEPTH, max_bins=FE_DT_BINS,
            min_info_gain=FE_DT_MIN_GAIN),
        "fare_z": fare.zscore(), "age_filled": age.fill_missing_with_mean(),
        "fare_pct": fare.calibrate_percentile(),
        "email_ok": stage("valid_email", fb.Email("Email").as_predictor()),
        "email_domain": stage("email_domains",
                              fb.EmailMap("EmailMap").as_predictor()),
        "phone_ok": stage("valid_phone", fb.Phone("Phone").as_predictor()),
        "bio_lang": stage("lang", bio),
        "boarded_dow": fb.Date("Boarded").as_predictor()
        .to_time_period("DayOfWeek"),
        "name_ticket_jaccard": name.jaccard_similarity(
            fb.Text("TicketText").as_predictor()),
    }
    f["bio_lda"] = f["bio_counts"].lda(k=FE_TOPICS)
    f["vectorized"] = pkg["transmogrify"]([
        *raw, f["age_filled"], f["fare_z"], f["fare_pct"], f["email_ok"],
        f["email_domain"], f["phone_ok"], f["bio_lang"], f["boarded_dow"],
        f["name_ticket_jaccard"]])
    f["combined"] = stage("combiner", f["vectorized"], f["name_tf"],
                          f["name_w2v"], f["bio_lda"], f["age_buckets"],
                          f["fare_buckets"])
    f["filtered"] = stage("min_variance", survived, f["combined"])
    f["checked"] = stage("checker", survived, f["filtered"])
    sel_cls = pkg["selector"]
    selector = (sel_cls.with_cross_validation()
                if models_and_parameters is None else
                sel_cls.with_cross_validation(
                    num_folds=3,
                    models_and_parameters=models_and_parameters))
    pred = selector.set_input(survived, f["checked"]).get_output()
    return pred, f, selector


class _CapturedLevels:
    """A ``hist_fn`` that launches the kernel, holds each level against
    the plain version (its count of unequal levels, and the worst error
    against the tolerance of |channels| as ``_LevelCheck`` states it)
    and keeps each level's inputs for timing."""

    def __init__(self):
        self.levels, self.unequal = 0, 0
        self.max_err, self.tol_ratio = 0.0, 0.0
        self.inputs = []

    def __call__(self, binned, slot, ch, M: int, B: int):
        k = gk.seg_level_hists(binned, slot, ch, M, B)
        p = gk.seg_level_hists_plain(binned, slot, ch, M, B)
        mag = gk.seg_level_hists_plain(binned, slot, ch.abs(), M, B)
        diff = (k - p).abs()
        self.levels += 1
        self.unequal += int(not torch.equal(k, p))
        self.max_err = max(self.max_err, float(diff.max()))
        self.tol_ratio = max(self.tol_ratio, float(
            (diff / (ATOL + RTOL * mag)).max()))
        self.inputs.append((binned, slot.clone(), ch.clone(), M, B))
        return k


def _d1_level_rows(values: np.ndarray, label: np.ndarray, path: str,
                   reps: int, bw: float, f32: float) -> Tuple[list, dict]:
    """A tree bucketizer's single-feature tree on the card (FE_DT_DEPTH
    levels at d = 1) through a capturing ``hist_fn``: each level held
    against the plain version, then timed: the kernel, the plain version,
    the library call (one weighted ``torch.bincount`` a channel) and the
    bound.  Returns the ``seg_hist`` rows and the check's summary."""
    integer = bool(np.all(label == np.round(label))) and \
        np.unique(label).size <= 20
    cap = _CapturedLevels()
    from transmogrifai_tpu_torch.ops.numeric import tree_split_points
    splits = tree_split_points(values, label, FE_DT_DEPTH, FE_DT_BINS,
                               FE_DT_MIN_GAIN, 1.0, "cuda", hist_fn=cap)
    rows = []
    for b, slot, ch, M, B in cap.inputs:
        n, dd = b.shape
        c = ch.shape[1]
        args = (b, slot, ch, M, B)
        nbytes = n * dd + n * 4 + n * c * 4 + c * M * B * dd * 4
        ops = n * dd * c
        rows.append({
            "phase": "seg_hist", "path": path, "N": n, "d": dd, "B": B,
            "nchan": c, "M": M, "row_stride": b.stride(0),
            "kernel_ms": time_ms(lambda: gk.seg_level_hists(*args), reps),
            "plain_ms": time_ms(lambda: gk.seg_level_hists_plain(*args), 3,
                                1),
            "library_ms": _library_ms(b, slot, ch, M, B),
            "bound_ms": max(nbytes / bw, ops / f32) * 1e3,
            "bound_by": "bytes" if nbytes / bw >= ops / f32
            else "operations", "bytes": nbytes})
    check_row = {"levels": cap.levels, "unequal": cap.unequal,
                 "integer_channels": integer, "max_abs_err": cap.max_err,
                 "tol_ratio": cap.tol_ratio, "splits": len(splits)}
    cap.inputs.clear()
    return rows, check_row


FE_OPTIONS_SCHEMA = {"NumMap": ft.RealMap, "TextMap": ft.TextMap,
                     "TagMap": ft.MultiPickListMap,
                     "GeoMap": ft.GeolocationMap, "Geo": ft.Geolocation,
                     "AgeYears": ft.Integral, "Words": ft.MultiPickList}


def fe_options_data(ds):
    """``ds`` (the feature_eng phase's rows) with the options leg's
    columns, each made from its own columns: NumMap {age, fare, sibsp},
    TextMap {sex, embarked, cabin}, TagMap {bio: Bio's first two words,
    deck: Cabin's deck}, GeoMap {home, work} and Geo (triples from Age,
    Fare, SibSp and Parch), AgeYears (Age's whole years, missing with
    it) and Words (Bio's first three words)."""
    def vals(name):
        c = ds[name]
        v = c.values.tolist()
        if c.mask is None:
            return v
        return [x if ok else None for x, ok in zip(v, c.mask.tolist())]

    age, fare, sib, par = (vals(k) for k in ("Age", "Fare", "SibSp",
                                             "Parch"))
    sex, emb, cab, bio = (vals(k) for k in ("Sex", "Embarked", "Cabin",
                                            "Bio"))

    def present(d):
        return {k: v for k, v in d.items() if v is not None}

    words = [b.split()[:3] for b in bio]
    home = [None if a is None or fare[i] is None else
            [fare[i] % 180 - 90, a * 3 % 360 - 180, 1.0]
            for i, a in enumerate(age)]
    cols = {
        "NumMap": [present({"age": age[i], "fare": fare[i],
                            "sibsp": sib[i]}) for i in range(len(ds))],
        "TextMap": [present({"sex": sex[i], "embarked": emb[i],
                             "cabin": cab[i]}) for i in range(len(ds))],
        "TagMap": [present({"bio": set(words[i][:2]),
                            "deck": None if cab[i] is None
                            else {cab[i][0]}}) for i in range(len(ds))],
        "GeoMap": [present({"home": home[i],
                            "work": None if not par[i] or sib[i] is None
                            else [sib[i] * 10 - 45, par[i] * 20 - 90, 2.0]})
                   for i in range(len(ds))],
        "Geo": home,
        "AgeYears": [None if a is None else float(int(a)) for a in age],
        "Words": [set(w) for w in words]}
    return ds.with_columns({k: FeatureColumn.from_values(
        FE_OPTIONS_SCHEMA[k], v) for k, v in cols.items()})


def build_fe_options():
    """The options leg's DAG: every option of the feature-engineering
    stages off its JAX default -> VectorsCombiner ->
    SanityChecker(remove_feature_group=False) -> an LR selector.
    Returns (prediction, {name: estimator}, combined, checked)."""
    from transmogrifai_tpu_torch.ops import map_vectorizers as mv
    from transmogrifai_tpu_torch.ops.date_geo import GeolocationVectorizer
    from transmogrifai_tpu_torch.ops.vectorizers import (
        IntegralVectorizer, MultiPickListVectorizer, OneHotVectorizer,
        VectorsCombiner)

    fb = FeatureBuilder
    survived = fb.RealNN("Survived").as_response()
    f = {k: getattr(fb, t.__name__)(k).as_predictor()
         for k, t in FE_OPTIONS_SCHEMA.items()}
    f.update({k: getattr(fb, t)(k).as_predictor() for k, t in (
        ("Name", "Text"), ("Bio", "Text"), ("Sex", "PickList"))})
    ests = {
        "num_map": mv.NumericMapVectorizer(
            allow_keys=["age", "fare"], block_keys=["fare"],
            fill_with_mean=False).set_input(f["NumMap"]),
        "text_map": mv.TextMapPivotVectorizer(
            allow_keys=["sex", "embarked"]).set_input(f["TextMap"]),
        "smart_text_map": mv.SmartTextMapVectorizer(
            block_keys=["cabin"]).set_input(f["TextMap"]),
        "tag_map": mv.MultiPickListMapVectorizer(
            block_keys=["deck"]).set_input(f["TagMap"]),
        "geo_map": mv.GeolocationMapVectorizer(
            allow_keys=["home"]).set_input(f["GeoMap"]),
        "geo": GeolocationVectorizer(fill_with_mean=False).set_input(
            f["Geo"]),
        "age_years": IntegralVectorizer(
            fill_with_mode=False, fill_value=FE_OPTIONS_FILL).set_input(
            f["AgeYears"]),
        "text": SmartTextVectorizer(auto_detect_languages=True).set_input(
            f["Name"], f["Bio"]),
        "words": MultiPickListVectorizer().set_input(f["Words"]),
        "sex": OneHotVectorizer().set_input(f["Sex"]),
    }
    combined = VectorsCombiner().set_input(
        *[e.get_output() for e in ests.values()]).get_output()
    checked = SanityChecker(remove_feature_group=False).set_input(
        survived, combined).get_output()
    sel = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=3, models_and_parameters=[
            (OpLogisticRegression(), grid(reg_param=[0.01]))])
    return (sel.set_input(survived, checked).get_output(), ests, combined,
            checked)


#: (map feature, its allowed keys): the options leg's vector may name
#: only these keys under each map, never a blocked one
FE_OPTIONS_KEYS = {"NumMap": {"age"}, "TextMap": {"sex", "embarked"},
                   "TagMap": {"bio"}, "GeoMap": {"home"}}


def _fe_options_leg(train, hold) -> dict:
    """Every item of the feature-engineering options off its default,
    trained on the card (FE_OPTIONS_ROWS + FE_OPTIONS_HOLDOUT rows of the
    phase's data): the vector names only allowed keys, the fills are the
    configured ones, save -> load -> score bitwise, the pivots' blocks."""
    train = fe_options_data(train.slice(0, FE_OPTIONS_ROWS))
    hold = fe_options_data(hold.slice(0, FE_OPTIONS_HOLDOUT))
    pred, ests, combined, checked = build_fe_options()
    wf = OpWorkflow().set_result_features(pred).set_input_data(train)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = wf.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0

    def fitted(key):
        return next(s for s in model.stages if s.uid == ests[key].uid)

    names = model.train_data[combined.name].vmeta.columns
    keys = {}
    for c in names:
        if c.parent_feature in FE_OPTIONS_KEYS:
            keys.setdefault(c.parent_feature, set()).add(c.grouping)
    fills = {"num_map": fitted("num_map").fills,
             "geo": fitted("geo").fills,
             "age_years": fitted("age_years").fills}
    proba = model.score(hold)[pred.name].values.probability
    tmp = os.path.join(REPO, "smoke_out")
    path = os.path.join(tmp, "fe_options")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        model.save(path)
        loaded = OpWorkflowModel.load(path)
        again = loaded.score(hold)[pred.name].values.probability
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    pivot = pivot_checks(model, train, "fe_options")
    leg = {"rows": len(train), "holdout": len(hold), "train_s": train_s,
           "width": len(names),
           "checked_width": int(model.train_data[checked.name]
                                .values.shape[1]),
           "map_keys": {k: sorted(v) for k, v in keys.items()},
           "fills": fills,
           "inert_recorded": {
               "auto_detect_languages": ests["text"].auto_detect_languages,
               "remove_feature_group": checked.origin_stage
               .remove_feature_group},
           "roundtrip_bitwise": bool(torch.equal(again, proba)),
           "finite": bool(torch.isfinite(proba).all()),
           "pivot_stages": [x["stage"] for x in pivot["stages"]],
           "predicted": FE_OPTIONS_PREDICTED}
    check(all(keys.get(k, set()) == v for k, v in FE_OPTIONS_KEYS.items()),
          f"feature_eng options: map keys {leg['map_keys']} are not the "
          f"allowed ones {FE_OPTIONS_KEYS}")
    check(fills["num_map"] == [{"age": 0.0}]
          and fills["geo"] == [[0.0, 0.0, 0.0]]
          and fills["age_years"] == [float(FE_OPTIONS_FILL)],
          f"feature_eng options: fills {fills}")
    check(leg["inert_recorded"] == {"auto_detect_languages": True,
                                    "remove_feature_group": False},
          f"feature_eng options: the inert options recorded as "
          f"{leg['inert_recorded']}")
    check(leg["roundtrip_bitwise"] and leg["finite"],
          "feature_eng options: scores after save/load differ")
    return leg


def phase_feature_eng(tdata, reps: int, bw: float, f32: float) -> dict:
    """The rest of feature engineering on the card (the module docstring's
    phase 6c): the feature_eng DAG trained on the Titanic phase's rows with
    the four extra columns, evaluated, saved and loaded; the tree
    bucketizers' splits through the kernel and the plain version; their
    d = 1 levels held and timed."""
    phase_t0 = time.perf_counter()
    train0, hold0, p_hold, _ = tdata
    train, hold, data_s = feature_eng_data(train0, hold0)
    pred, f, selector = build_feature_eng(feature_eng_stages())
    wf = OpWorkflow().set_result_features(pred).set_input_data(train)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gk.seg_level_hists.launches = 0
    t0 = time.perf_counter()
    model = wf.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = gk.seg_level_hists.launches
    peak = torch.cuda.max_memory_allocated()

    t0 = time.perf_counter()
    scored, metrics = model.score_and_evaluate(
        Evaluators.BinaryClassification.auPR(), data=hold)
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    proba = scored[pred.name].values.probability
    y_hold = torch.as_tensor(np.asarray(hold["Survived"].values, np.float32))
    attainable = aupr(y_hold, torch.from_numpy(p_hold.astype(np.float32)))
    aupr_hold = float(metrics["AuPR"])

    def fitted(key):
        uid = f[key].origin_stage.uid
        return next(s for s in model.stages if s.uid == uid)

    w2v = f["name_w2v"].origin_stage
    widths = {k: int(model.train_data[f[k].name].values.shape[1])
              for k in ("vectorized", "combined", "filtered", "checked")}
    buckets = {k: fitted(k).split_points
               for k in ("age_buckets", "fare_buckets")}

    # the bucketizers' splits through the plain version on the same rows
    y = np.nan_to_num(np.asarray(train["Survived"].values, np.float64))
    plain_equal, kernel_rows, level_checks = {}, [], {}
    for key, col in (("age_buckets", "Age"), ("fare_buckets", "Fare")):
        c = train[col]
        m = np.asarray(c.mask)
        x = np.asarray(c.values, np.float64)[m]
        args = (x, y[m], FE_DT_DEPTH, FE_DT_BINS, FE_DT_MIN_GAIN, 1.0,
                "cuda")
        from transmogrifai_tpu_torch.ops.numeric import tree_split_points
        kern = tree_split_points(*args)
        plain = tree_split_points(*args, hist_fn=gk.seg_level_hists_plain)
        stage_splits = buckets[key][1:-1] if buckets[key] else []
        plain_equal[key] = kern == plain and kern == stage_splits
        rows, level_checks[key] = _d1_level_rows(
            x, y[m], f"dt_bucketizer_{col.lower()}", reps, bw, f32)
        kernel_rows += rows
    # K = 1: the bucketizer's tree on a continuous label (log fare against
    # age), 3 float channels
    c = train["Age"]
    m = np.asarray(c.mask) & np.asarray(train["Fare"].mask)
    rows, level_checks["continuous"] = _d1_level_rows(
        np.asarray(c.values, np.float64)[m],
        np.log1p(np.asarray(train["Fare"].values, np.float64)[m]),
        "dt_bucketizer_continuous", reps, bw, f32)
    kernel_rows += rows

    # save -> load on the card -> FE_ROUNDTRIP_ROWS holdout rows bitwise
    tmp = os.path.join(REPO, "smoke_out")
    path = os.path.join(tmp, "feature_eng")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        t0 = time.perf_counter()
        model.save(path)
        save_s = time.perf_counter() - t0
        nbytes = _dir_bytes(path)
        t0 = time.perf_counter()
        loaded = OpWorkflowModel.load(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        # the same rows through both (a batch of another size may take
        # other product kernels)
        part = hold.slice(0, FE_ROUNDTRIP_ROWS)
        before = model.score(part)[pred.name].values.probability
        again = loaded.score(part)[pred.name].values.probability
        bitwise = bool(torch.equal(again, before))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    options = _fe_options_leg(train, hold)

    meta = selector.metadata
    summary = meta["model_selector_summary"]
    results = summary["validationResults"]
    new_stages = ("TextTokenizer", "OpStopWordsRemover", "OpNGram",
                  "OpHashingTF", "OpWord2Vec", "OpCountVectorizer", "OpLDA",
                  "DecisionTreeNumericBucketizer", "OpScalarStandardScaler",
                  "FillMissingWithMean", "PercentileCalibrator",
                  "ValidEmailTransformer", "EmailToPickListMapTransformer",
                  "IsValidPhoneDefaultCountry", "LangDetector",
                  "TimePeriodTransformer", "JaccardSimilarity",
                  "MinVarianceFilter")
    secs = model.stage_seconds
    out = {"phase": "feature_eng", "rows": len(train), "holdout": len(hold),
           "data_s": data_s, "train_s": train_s, "score_s": score_s,
           "stage_seconds": secs,
           "new_stage_seconds": {k: secs.get(k) for k in new_stages},
           "w2v_pairs": w2v.metadata.get("w2v_pairs"),
           "w2v_steps": w2v.metadata.get("w2v_steps"),
           "w2v_s": secs.get("OpWord2Vec"), "lda_s": secs.get("OpLDA"),
           "widths": widths, "bucket_splits": buckets,
           "min_variance_dropped": len(
               f["filtered"].origin_stage.metadata["summary"]["dropped"]),
           "checker_dropped": len(
               f["checked"].origin_stage.metadata["summary"]["dropped"]),
           "winner": summary["bestModelType"],
           "winner_params": summary["bestModelParams"],
           "cv": [{"model": r["modelType"], "params": r["params"],
                   "metric": r["metricValue"], "error": r.get("error")}
                  for r in results],
           "group_errors": meta["group_errors"],
           "holdout_aupr": aupr_hold, "attainable_aupr": attainable,
           "aupr_floor": FE_AUPR_SHARE * attainable,
           "holdout_metrics": metrics,
           "seg_hist_launches": launches,
           "growers_hist_levels": meta["hist_levels"],
           "max_memory_allocated": peak,
           "splits_kernel_equal_plain": plain_equal,
           "d1_level_checks": level_checks,
           "save_s": save_s, "load_s": load_s, "artifact_bytes": nbytes,
           "roundtrip_rows": FE_ROUNDTRIP_ROWS,
           "roundtrip_bitwise": bitwise, "options": options,
           "phase_s": time.perf_counter() - phase_t0}
    emit(out)
    for r in kernel_rows:
        emit(r)
    bucket_levels = sum(c["levels"] for c in level_checks.values())
    check(tuple(proba.shape) == (len(hold), 2), f"proba shape {proba.shape}")
    check(bool(torch.isfinite(proba).all()), "non-finite probabilities")
    errors = [r["error"] for r in results if r.get("error")]
    check(not errors, f"feature_eng: candidates failed: {errors}")
    check(not meta["group_errors"],
          f"feature_eng: grid groups failed: {meta['group_errors']}")
    check(aupr_hold >= FE_AUPR_SHARE * attainable,
          f"feature_eng: holdout AuPR {aupr_hold} below {FE_AUPR_SHARE} x "
          f"the attainable {attainable}")
    check(all(plain_equal.values()),
          f"feature_eng: bucketizer splits through the kernel and the "
          f"plain version differ: {plain_equal}")
    for key, c in level_checks.items():
        ok = (c["unequal"] == 0 if c["integer_channels"]
              else c["tol_ratio"] <= 1.0)
        check(ok and c["levels"] == FE_DT_DEPTH,
              f"feature_eng: d = 1 levels of {key} off the plain version: "
              f"{c}")
    # the train's launches: the selector's forests and the two
    # bucketizers' FE_DT_DEPTH levels of 5 channels (one launch each)
    check(launches == meta["hist_levels"] + 2 * FE_DT_DEPTH,
          f"feature_eng: seg_hist launches {launches} != the growers' "
          f"{meta['hist_levels']} + the bucketizers' {2 * FE_DT_DEPTH}")
    check(bitwise, "feature_eng: scores after save/load differ")
    return {"seg_hist_launches": launches, "bucket_levels": bucket_levels}


# ---------------------------------------------------------------------------
# the avro_combined phase: the reference's Avro ensemble demo
# ---------------------------------------------------------------------------

def avro_records(cols: dict, lo: int, hi: int) -> list:
    """Rows ``lo``..``hi`` of ``titanic_columns``' columns as the Avro
    demo's records (AVRO_SCHEMA: a missing age is null)."""
    names = [f["name"] for f in AVRO_SCHEMA["fields"]]
    conv = {"Survived": float, "Pclass": str, "Sex": str, "SibSp": int,
            "Parch": int, "Fare": float, "Embarked": str,
            "Age": lambda v: None if v != v else float(v)}
    lists = [list(map(conv[k], cols[k][lo:hi].tolist())) for k in names]
    return [dict(zip(names, vals)) for vals in zip(*lists)]


def build_avro_combined(avro_path: str):
    """examples/op_titanic_avro_combined.py's ``build`` with the port's
    imports: a linear selector (LR {0.01, 0.1}, an MLP [8] of 200 steps of
    0.1) and a tree selector (50-tree forests at depths 6 and 12, min info
    gain 0.001), each 3-fold CV on the checked Titanic columns, blended by
    ``SelectedModelCombiner(combination_strategy="weighted")``; the
    workflow reads ``avro_path`` through ``AvroReader``.  Returns (wf,
    combined, linear prediction, tree prediction, checked)."""
    survived = FeatureBuilder.RealNN("Survived").as_response()
    predictors = [
        FeatureBuilder.PickList("Pclass").as_predictor(),
        FeatureBuilder.PickList("Sex").as_predictor(),
        FeatureBuilder.Real("Age").as_predictor(),
        FeatureBuilder.Integral("SibSp").as_predictor(),
        FeatureBuilder.Integral("Parch").as_predictor(),
        FeatureBuilder.Real("Fare").as_predictor(),
        FeatureBuilder.PickList("Embarked").as_predictor(),
    ]
    features = transmogrify(predictors)
    checked = SanityChecker(remove_bad_features=True).set_input(
        survived, features).get_output()
    linear = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=3,
        models_and_parameters=[
            (OpLogisticRegression(), grid(reg_param=[0.01, 0.1])),
            (OpMultilayerPerceptronClassifier(max_iter=200, step_size=0.1),
             grid(hidden_layers=[[8]])),
        ]).set_input(survived, checked)
    trees = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=3,
        models_and_parameters=[
            (OpRandomForestClassifier(),
             grid(num_trees=[50], max_depth=[6, 12],
                  min_info_gain=[0.001])),
        ]).set_input(survived, checked)
    combined = SelectedModelCombiner(
        combination_strategy="weighted").set_input(
        survived, linear.get_output(), trees.get_output()).get_output()
    wf = (OpWorkflow()
          .set_result_features(combined, linear.get_output(),
                               trees.get_output())
          .set_reader(AvroReader(avro_path)))
    return wf, combined, linear.get_output(), trees.get_output(), checked


def _svc_nb_leg(data, selector_aupr: float) -> dict:
    """``OpLinearSVC().fit_raw`` and ``OpNaiveBayes().fit_raw`` on the
    slice's 1M x 500 matrix, ``predict_batch`` on its holdout: fit
    seconds, the SVC's Newton steps, holdout AuPR (the SVC's margin, NB's
    probability) against its floor."""
    train, hold, _ = data
    dev = resolve_device()
    cols = len([k for k in train.columns if k.startswith("f")])

    names = [f"f{j}" for j in range(cols)]
    X, Xh = (_device_matrix(ds, names, dev) for ds in (train, hold))
    y = np.asarray(train["label"].values, np.float32)
    yh = torch.from_numpy(np.asarray(hold["label"].values, np.float32))
    out = {"rows": int(X.shape[0]), "cols": cols}
    floors = {"svc": SVC_AUPR_SHARE * selector_aupr,
              "nb": float(yh.mean()) + NB_AUPR_MARGIN}
    for key, est in (("svc", OpLinearSVC()), ("nb", OpNaiveBayes())):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = est.fit_raw(X, y, device=dev)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        batch = model.predict_batch(Xh)
        score = (batch.raw_prediction[:, 1] if batch.probability is None
                 else batch.probability[:, 1])
        out[key] = {"fit_s": fit_s, "n_iter": est.metadata.get("n_iter"),
                    "holdout_aupr": aupr(yh.to(dev), score),
                    "aupr_floor": floors[key],
                    "finite": bool(torch.isfinite(score).all())}
    del X, Xh
    return out


def phase_avro_combined(data, selector_aupr: float, reps: int, bw: float,
                        f32: float, rows: int = 0, holdout: int = 0) -> dict:
    """The reference's Avro ensemble demo on the card (the module
    docstring's phase 6d): the Titanic columns written to Avro by the
    port's ``write_avro`` (deflate) and read inside ``train()`` by
    ``AvroReader``; both selectors, the weighted combiner, holdout AuPRs,
    the kernel's launches against the forests' levels, the demo's depth-12
    levels bitwise against the plain version, save/load; then the linear
    SVC and naive Bayes leg on the slice's matrix (``data``).  The demo
    runs on ``rows`` + ``holdout`` Titanic rows (0: ``data``'s)."""
    phase_t0 = time.perf_counter()
    rows, holdout = rows or len(data[0]), holdout or len(data[1])
    t0 = time.perf_counter()
    cols, p = titanic_columns(rows + holdout)
    columns_s = time.perf_counter() - t0
    tmp = os.path.join(REPO, "smoke_out")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    train_path = os.path.join(tmp, "train.avro")
    hold_path = os.path.join(tmp, "holdout.avro")
    try:
        t0 = time.perf_counter()
        write_avro(train_path, AVRO_SCHEMA, avro_records(cols, 0, rows))
        write_avro(hold_path, AVRO_SCHEMA,
                   avro_records(cols, rows, rows + holdout))
        avro_write_s = time.perf_counter() - t0
        avro_bytes = os.path.getsize(train_path) + os.path.getsize(
            hold_path)
        p_hold = p[rows:]
        del cols, p

        wf, combined, p_lin, p_tree, checked = build_avro_combined(
            train_path)
        reader = wf.reader
        check(reader.estimate_rows() == rows,
              f"avro_combined: estimate_rows {reader.estimate_rows()} != "
              f"{rows}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        gk.seg_level_hists.launches = 0
        t0 = time.perf_counter()
        model = wf.train()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = gk.seg_level_hists.launches
        peak = torch.cuda.max_memory_allocated()
        read_s = dict(reader.read_seconds)

        hold_reader = AvroReader(hold_path)
        t0 = time.perf_counter()
        hold = hold_reader.generate_dataset(model.raw_features())
        hold_read_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        scored = model.score(hold)
        torch.cuda.synchronize()
        score_s = time.perf_counter() - t0
        y_hold = torch.as_tensor(np.asarray(hold["Survived"].values,
                                            np.float32))
        attainable = aupr(y_hold, torch.from_numpy(p_hold.astype(
            np.float32)))
        preds = {"linear": p_lin, "trees": p_tree, "combined": combined}
        probas = {k: scored[f.name].values.probability
                  for k, f in preds.items()}
        holdout_aupr = {k: aupr(y_hold.to(v.device), v[:, 1])
                        for k, v in probas.items()}

        sels = {k: f.origin_stage for k, f in
                (("linear", p_lin), ("trees", p_tree))}
        comb_stage = next(s for s in model.stages
                          if s.uid == combined.origin_stage.uid)
        info = comb_stage.metadata["combiner"]
        summaries = {k: s.metadata["model_selector_summary"]
                     for k, s in sels.items()}
        forest_levels = sum(s.metadata["hist_levels"]
                            for s in sels.values())

        # the demo's depth-12 forest levels on the checked matrix, bitwise
        X = model.train_data[checked.name].values
        y = np.asarray(model.train_data["Survived"].values, np.float32)
        kernel_row = _titanic_levels(X, y, int(np.sqrt(X.shape[1])), reps,
                                     bw, f32)
        kernel_row["path"] = "avro_combined"
        checked_cols = int(X.shape[1])
        del X

        # save -> load on the card -> AVRO_ROUNDTRIP_ROWS holdout rows
        path = os.path.join(tmp, "avro_combined")
        t0 = time.perf_counter()
        model.save(path)
        save_s = time.perf_counter() - t0
        nbytes = _dir_bytes(path)
        t0 = time.perf_counter()
        loaded = OpWorkflowModel.load(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        part = hold.slice(0, AVRO_ROUNDTRIP_ROWS)
        before = model.score(part)[combined.name].values.probability
        again = loaded.score(part)[combined.name].values.probability
        bitwise = bool(torch.equal(again, before))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    leg = _svc_nb_leg(data, selector_aupr)

    out = {"phase": "avro_combined", "rows": rows, "holdout": holdout,
           "columns_s": columns_s, "avro_write_s": avro_write_s,
           "avro_bytes": avro_bytes, "avro_read_s": read_s,
           "holdout_read_s": hold_read_s, "train_s": train_s,
           "score_s": score_s, "stage_seconds": model.stage_seconds,
           "checked_cols": checked_cols,
           "sweep_seconds": {k: s.metadata["sweep_seconds"]
                             for k, s in sels.items()},
           "refit_seconds": {k: s.metadata["refit_seconds"]
                             for k, s in sels.items()},
           "sequential_fits": sels["linear"].metadata["sequential_fits"],
           "group_errors": {k: s.metadata["group_errors"]
                            for k, s in sels.items()},
           "winners": {k: [v["bestModelType"], v["bestModelParams"]]
                       for k, v in summaries.items()},
           "cv": {k: [{"model": r["modelType"], "params": r["params"],
                       "metric": r["metricValue"], "error": r.get("error")}
                      for r in v["validationResults"]]
                  for k, v in summaries.items()},
           "combiner": info,
           "holdout_aupr": holdout_aupr, "attainable_aupr": attainable,
           "aupr_floor": AVRO_AUPR_SHARE * attainable,
           "seg_hist_launches": launches, "forest_levels": forest_levels,
           "max_memory_allocated": peak,
           "save_s": save_s, "load_s": load_s, "artifact_bytes": nbytes,
           "roundtrip_rows": AVRO_ROUNDTRIP_ROWS,
           "roundtrip_bitwise": bitwise, "svc_nb": leg,
           "phase_s": time.perf_counter() - phase_t0}
    emit(out)
    emit(kernel_row)
    for k, v in probas.items():
        check(tuple(v.shape) == (holdout, 2) and bool(
            torch.isfinite(v).all()),
              f"avro_combined: {k} probabilities {tuple(v.shape)} not "
              f"finite of the holdout's shape")
    for k, v in summaries.items():
        errors = [r["error"] for r in v["validationResults"]
                  if r.get("error")]
        check(not errors, f"avro_combined: {k} candidates failed: {errors}")
        check(not sels[k].metadata["group_errors"],
              f"avro_combined: {k} grid groups failed: "
              f"{sels[k].metadata['group_errors']}")
    # the weighted rule: weights in proportion to the two winners'
    # validation AuPR (the metric to maximize), summing to 1
    m1, m2 = info["metricValue1"], info["metricValue2"]
    check(info["strategy"] == "weighted" and info["metricName"] == "AuPR"
          and abs(info["weight1"] - m1 / (m1 + m2)) <= 1e-12
          and abs(info["weight1"] + info["weight2"] - 1.0) <= 1e-12,
          f"avro_combined: combiner weights {info} break the weighted "
          f"rule")
    lin_best = summaries["linear"]
    check(abs(m1 - next(r["metricValue"]
                        for r in lin_best["validationResults"]
                        if r["modelType"] == lin_best["bestModelType"]
                        and r["params"] == lin_best["bestModelParams"]))
          == 0.0, "avro_combined: the combiner's first metric is not the "
          "linear winner's validation AuPR")
    for k, v in holdout_aupr.items():
        check(v >= AVRO_AUPR_SHARE * attainable,
              f"avro_combined: {k} holdout AuPR {v} below "
              f"{AVRO_AUPR_SHARE} x the attainable {attainable}")
    check(launches > 0 and launches == forest_levels,
          f"avro_combined: seg_hist launches {launches} != the forests' "
          f"{forest_levels} levels")
    check(kernel_row["bitwise_equal"] and kernel_row["levels_checked"] > 0,
          f"avro_combined: {kernel_row['levels_unequal']} of "
          f"{kernel_row['levels_checked']} levels differ from the plain "
          f"version by up to {kernel_row['max_abs_err']}")
    check(bitwise, "avro_combined: scores after save/load differ")
    for key in ("svc", "nb"):
        r = leg[key]
        check(r["finite"] and r["holdout_aupr"] >= r["aupr_floor"],
              f"avro_combined: {key} holdout AuPR {r['holdout_aupr']} "
              f"below its floor {r['aupr_floor']}")
    return {"seg_hist_launches": launches}


# ---------------------------------------------------------------------------
# the out_of_core phase: train(chunk_rows=k) from a CSV, the streamed
# prefix and the default selector as the tail, and the drift monitor
# ---------------------------------------------------------------------------

def ooc_columns(n: int):
    """``titanic_columns``' n rows with validate_explain's two planted raw
    features (``leak``: null exactly where Survived is 1; ``rare``: filled
    on VE_RARE_SHARE of the rows), and the true probabilities."""
    cols, p = titanic_columns(n)
    rng = np.random.default_rng(VE_SEED)
    cols["leak"] = np.where(cols["Survived"] == 1, np.nan,
                            rng.normal(size=n))
    cols["rare"] = np.where(rng.random(n) < VE_RARE_SHARE,
                            rng.normal(size=n), np.nan)
    return cols, p


def write_ooc_csv(path: str, cols: dict, lo: int, hi: int) -> None:
    """Rows ``lo``..``hi`` as CSV with the ``csv`` module: floats by repr,
    a missing value as an empty cell."""
    names = list(cols)

    def cells(v):
        if v.dtype.kind == "f":
            return ["" if x != x else repr(x) for x in v[lo:hi].tolist()]
        return ["" if x is None else x for x in v[lo:hi].tolist()]

    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(names)
        w.writerows(zip(*(cells(cols[k]) for k in names)))


def build_bench_ingest(extra=()):
    """examples/bench_ingest.py's DAG with the port's imports: the demo's
    ten predictors (and ``extra`` Reals) -> transmogrify ->
    SanityChecker(max_correlation=0.99) -> OpNaiveBayes."""
    survived = FeatureBuilder.RealNN("Survived").as_response()
    feats = transmogrify([getattr(FeatureBuilder, t)(n).as_predictor()
                          for t, n in OOC_PREDICTORS]
                         + [FeatureBuilder.Real(n).as_predictor()
                            for n in extra])
    checked = SanityChecker(max_correlation=0.99).set_input(
        survived, feats).get_output()
    return OpNaiveBayes().set_input(survived, checked).get_output()


def build_ooc_selector(models_and_parameters=None):
    """Leg b's DAG: the ten predictors and the two planted features ->
    transmogrify -> SanityChecker() -> the default binary selector (or
    one over ``models_and_parameters``).  Returns (prediction, checked,
    selector)."""
    survived = FeatureBuilder.RealNN("Survived").as_response()
    feats = transmogrify([getattr(FeatureBuilder, t)(n).as_predictor()
                          for t, n in OOC_PREDICTORS]
                         + [FeatureBuilder.Real(n).as_predictor()
                            for n in ("leak", "rare")])
    checked = SanityChecker().set_input(survived, feats).get_output()
    sel = BinaryClassificationModelSelector.with_cross_validation(
        models_and_parameters=models_and_parameters)
    return sel.set_input(survived, checked).get_output(), checked, sel


def _rss_bytes() -> int:
    """This process's resident set now (``/proc/self/statm``)."""
    with open("/proc/self/statm") as fh:
        return int(fh.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


class _PeakRSS:
    """The peak of this process's resident set while the ``with`` block
    runs, sampled every ``interval_s`` on a thread: a child's
    ``ru_maxrss`` starts at the forking parent's peak."""

    def __init__(self, interval_s: float = 0.005):
        self.interval_s = interval_s
        self.peak = 0
        self._stop = threading.Event()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.peak = max(self.peak, _rss_bytes())

    def __enter__(self) -> "_PeakRSS":
        self.peak = _rss_bytes()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, _rss_bytes())


def _stage_of(model, cls: str):
    return [s for s in model.stages if type(s).__name__ == cls]


def _model_params(model) -> dict:
    """The fitted prefix's results a leg compares: fills, vocabularies,
    text strategies, the checker's keep list, naive Bayes's parameters."""
    out = {"fills": [m.fills for m in _stage_of(model,
                                                "RealVectorizerModel")],
           "vocabs": [m.vocabs for m in _stage_of(model,
                                                  "OneHotVectorizerModel")],
           "text": [[m.strategies, m.vocabs] for m in _stage_of(
               model, "SmartTextVectorizerModel")],
           "keep": [m.keep_indices for m in _stage_of(
               model, "SanityCheckerModel")]}
    nb = _stage_of(model, "NaiveBayesModel")
    if nb:
        out["nb"] = [nb[0].log_prior.cpu().tolist(),
                     nb[0].log_lik.cpu().tolist()]
    return out


def ooc_child(train_csv: str, hold_csv: str, mode: str,
              chunk_rows: int) -> None:
    """Leg a's train in this process (each mode runs in a child of its
    own, so that nothing of the other's memory stays resident): the
    bench_ingest DAG from ``train_csv``, in-core or chunked; prints one
    JSON line."""
    dev = resolve_device()
    torch.zeros(1, device=dev)           # the CUDA context in the baseline
    pred = build_bench_ingest()
    wf = OpWorkflow().set_result_features(pred).set_reader(
        CSVReader(train_csv))
    base_rss = _rss_bytes()
    torch.cuda.reset_peak_memory_stats()
    with _PeakRSS() as rss:
        t0 = time.perf_counter()
        model = wf.train(chunk_rows=chunk_rows if mode == "chunked"
                         else None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak_rss = rss.peak
    peak_dev = torch.cuda.max_memory_allocated()
    hold = CSVReader(hold_csv).generate_dataset(model.raw_features())
    proba = model.score(hold)[pred.name].values.probability
    y = torch.as_tensor(np.asarray(hold["Survived"].values, np.float32))
    out = {"mode": mode, "wall_s": wall, "rows": len(model.train_data),
           "baseline_rss_bytes": base_rss, "peak_rss_bytes": peak_rss,
           "rss_delta_bytes": peak_rss - base_rss,
           "max_memory_allocated": peak_dev,
           "holdout_aupr": aupr(y.to(proba.device), proba[:, 1]),
           "finite": bool(torch.isfinite(proba).all()),
           "stage_seconds": model.stage_seconds,
           "params": _model_params(model)}
    ip = model.ingest_profile
    if ip is not None:
        out.update({
            "chunk_rows": chunk_rows, "passes": [
                {k: p.to_json()[k] for k in (
                    "label", "chunks", "rows", "bytesRead", "readSecs",
                    "transformSecs", "wallSecs", "rowsPerSec",
                    "overlapEfficiency")} for p in ip.passes],
            "bytes_read": ip.total_bytes,
            "overlap_efficiency": max(p.overlap_efficiency
                                      for p in ip.passes),
            "rows_per_s": min(p.rows_per_s for p in ip.passes
                              if p.rows_per_s > 0),
            "spilled_mb": ip.spilled_bytes / 1e6,
            "not_streamed": _not_streamed(pred, model)})
    print(json.dumps(out), flush=True)


def _not_streamed(pred: Feature, model) -> list:
    """The DAG's estimators that an out-of-core train fitted in-core."""
    streamed = model.fit_states or {}
    return [type(s).__name__ for s in compute_dag([pred]).all_stages()
            if isinstance(s, Estimator) and s.uid not in streamed]


def _ckpt_train(train_csv: str, hold_csv: str, ckpt: str,
                chunk_rows: Optional[int] = None):
    """Leg d's train: leg b's DAG (the filter, the streamed prefix, the
    default selector) chunked (OOC_CKPT_CHUNK_ROWS unless ``chunk_rows``)
    with a checkpoint in ``ckpt``: (model, prediction, wall seconds,
    seg_hist launches).  The stages are numbered from 1, as the same
    script's first run numbers them, so a resume's fingerprint matches."""
    from transmogrifai_tpu_torch.utils.uid import reset_uids

    reset_uids()
    pred, _, _ = build_ooc_selector()
    wf = (OpWorkflow().set_result_features(pred)
          .set_reader(CSVReader(train_csv))
          .with_raw_feature_filter(scoring_data=CSVReader(hold_csv)))
    torch.cuda.synchronize()
    gk.seg_level_hists.launches = 0
    t0 = time.perf_counter()
    model = wf.train(chunk_rows=chunk_rows or OOC_CKPT_CHUNK_ROWS,
                     checkpoint_dir=ckpt,
                     checkpoint_every_chunks=OOC_CKPT_EVERY)
    torch.cuda.synchronize()
    return (model, pred, time.perf_counter() - t0,
            gk.seg_level_hists.launches)


def ckpt_child(train_csv: str, hold_csv: str, ckpt: str) -> None:
    """Leg d's train in a child process, which the parent's TMOG_FAULTS
    kills at a checkpoint save; the line below prints only if it was
    not killed."""
    _ckpt_train(train_csv, hold_csv, ckpt)
    print("chip_smoke: the checkpointed train finished", flush=True)


def _ooc_leg_d(cols: dict, rows: int, tmp: str) -> dict:
    """Kill and resume: the first OOC_CKPT_ROWS train rows and
    OOC_CKPT_HOLDOUT holdout rows of the phase's columns; leg b's DAG
    trained chunked with a checkpoint, uninterrupted, then in a child
    killed at checkpoint save OOC_CKPT_KILL_AT, then resumed here from
    the child's directory."""
    from transmogrifai_tpu_torch.workflow.checkpoint import (
        CHECKPOINT_JSON, CheckpointMismatchError)

    train_csv = os.path.join(tmp, "d_train.csv")
    hold_csv = os.path.join(tmp, "d_holdout.csv")
    write_ooc_csv(train_csv, cols, 0, OOC_CKPT_ROWS)
    write_ooc_csv(hold_csv, cols, rows, rows + OOC_CKPT_HOLDOUT)
    hold_reader = CSVReader(hold_csv)

    def results(model, pred):
        hold = hold_reader.generate_dataset(model.raw_features())
        return ({"vocabs": [m.vocabs for m in _stage_of(
                    model, "OneHotVectorizerModel")],
                 "text": [[m.strategies, m.vocabs] for m in _stage_of(
                     model, "SmartTextVectorizerModel")],
                 "dropped": model.raw_feature_filter_results
                 .dropped_features,
                 "keep": [m.keep_indices for m in _stage_of(
                     model, "SanityCheckerModel")]},
                model.score(hold)[pred.name].values.probability)

    ref_dir = os.path.join(tmp, "ckpt_uninterrupted")
    m0, pred0, wall0, launches0 = _ckpt_train(train_csv, hold_csv, ref_dir)
    r0, p0 = results(m0, pred0)
    ip0 = m0.ingest_profile
    ref_gone = not os.path.exists(ref_dir)

    killed_dir = os.path.join(tmp, "ckpt_killed")
    env = dict(os.environ, TMOG_FAULTS=json.dumps({"faults": [
        {"point": "checkpoint.barrier", "action": "kill",
         "at": OOC_CKPT_KILL_AT}]}))
    cmd = [sys.executable, os.path.abspath(__file__), "--ckpt-child",
           killed_dir, "--ooc-train", train_csv, "--ooc-holdout", hold_csv]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=600)
    child_s = time.perf_counter() - t0
    check(proc.returncode == -9 and "finished" not in proc.stdout,
          f"out_of_core d: the child was not killed at its checkpoint "
          f"(exit {proc.returncode}): {proc.stderr[-2000:]}")
    with open(os.path.join(killed_dir, CHECKPOINT_JSON)) as fh:
        saved = json.load(fh)["current"]
    # another chunk geometry against the kept checkpoint: refused
    try:
        _ckpt_train(train_csv, hold_csv, killed_dir,
                    chunk_rows=OOC_CKPT_CHUNK_ROWS // 2)
        mismatch = None
    except CheckpointMismatchError as exc:
        mismatch = str(exc)
    kept = os.path.exists(os.path.join(killed_dir, CHECKPOINT_JSON))

    m1, pred1, wall1, launches1 = _ckpt_train(train_csv, hold_csv,
                                              killed_dir)
    r1, p1 = results(m1, pred1)
    ip1 = m1.ingest_profile
    skipped = ip1.passes[0].chunks_skipped
    err = float((p1 - p0).abs().max())
    leg = {"rows": OOC_CKPT_ROWS, "holdout": OOC_CKPT_HOLDOUT,
           "chunk_rows": OOC_CKPT_CHUNK_ROWS,
           "chunks": ip0.passes[0].chunks,
           "checkpoint_every": OOC_CKPT_EVERY,
           "kill_at_save": OOC_CKPT_KILL_AT,
           "uninterrupted_s": wall0, "child_s": child_s, "resume_s": wall1,
           "checkpoint_saves": ip0.checkpoint_saves,
           "checkpoint_s": ip0.checkpoint_wall_s,
           "checkpoint_share": ip0.checkpoint_wall_s / wall0,
           "resume_checkpoint_saves": ip1.checkpoint_saves,
           "killed_at_chunks_done": saved["chunks_done"],
           "resumed": ip1.resumed, "chunks_skipped": skipped,
           "passes": {"uninterrupted": [q.label for q in ip0.passes],
                      "resumed": [q.label for q in ip1.passes]},
           "vocabs_equal": r1["vocabs"] == r0["vocabs"]
           and r1["text"] == r0["text"],
           "dropped": r1["dropped"],
           "dropped_equal": r1["dropped"] == r0["dropped"],
           "keep_equal": r1["keep"] == r0["keep"],
           "proba_max_abs_err": err, "proba_tol": OOC_CKPT_PROBA_TOL,
           "proba_bitwise": bool(torch.equal(p1, p0)),
           "checkpoint_removed": ref_gone and not os.path.exists(killed_dir),
           "mismatch_refused": mismatch is not None and "chunkRows"
           in mismatch, "checkpoint_kept_after_refusal": kept,
           "seg_hist_launches": {"uninterrupted": launches0,
                                 "resumed": launches1},
           "predicted": OOC_CKPT_PREDICTED}
    ref = {"train_csv": train_csv, "hold_csv": hold_csv,
           "fit_states": m0.fit_states,
           "dropped": r0["dropped"]}
    check(leg["resumed"] and skipped > 0
          and skipped == saved["chunks_done"],
          f"out_of_core d: the resume skipped {skipped} chunks of the "
          f"{saved['chunks_done']} saved (resumed {leg['resumed']})")
    check(leg["vocabs_equal"] and leg["dropped_equal"] and leg["keep_equal"],
          "out_of_core d: the resumed train's vocabularies, drop list or "
          "keep list differ from the uninterrupted train's")
    check(bool(torch.isfinite(p1).all()) and err <= OOC_CKPT_PROBA_TOL,
          f"out_of_core d: resumed probabilities {err} from the "
          f"uninterrupted train's")
    check(leg["checkpoint_removed"],
          "out_of_core d: a checkpoint directory outlived its train")
    check(leg["mismatch_refused"] and kept,
          f"out_of_core d: another chunk_rows was not refused by name: "
          f"{mismatch}")
    check(launches0 > 0 and launches1 > 0,
          f"out_of_core d: seg_hist launches {launches0}, {launches1}")
    return leg, ref


def _run_ooc_child(train_csv: str, hold_csv: str, mode: str,
                   chunk_rows: int) -> dict:
    cmd = [sys.executable, os.path.abspath(__file__), "--ooc-child", mode,
           "--ooc-train", train_csv, "--ooc-holdout", hold_csv,
           "--ooc-chunk-rows", str(chunk_rows)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    check(proc.returncode == 0 and lines,
          f"out_of_core: the {mode} child failed (exit {proc.returncode}): "
          f"{proc.stderr[-2000:]}")
    return json.loads(lines[-1])


def _ooc_leg_a(train_csv: str, hold_csv: str, base_rate: float,
               attainable: float) -> dict:
    """bench_ingest's DAG at full size, in-core and chunked, each in its
    own child; the guards of leg a."""
    inc = _run_ooc_child(train_csv, hold_csv, "in_core", 0)
    ch = _run_ooc_child(train_csv, hold_csv, "chunked", OOC_CHUNK_ROWS)
    a, b = ch["params"], inc["params"]
    fill_err = max((abs(x - y) / max(abs(y), 1e-300)
                    for fa, fb in zip(a["fills"], b["fills"])
                    for x, y in zip(fa, fb)), default=0.0)
    nb_err = max(float(np.abs(np.asarray(x) - np.asarray(y)).max())
                 for x, y in zip(a["nb"], b["nb"]))
    floor = base_rate + OOC_NB_AUPR_MARGIN
    leg = {"in_core": {k: v for k, v in inc.items() if k != "params"},
           "chunked": {k: v for k, v in ch.items() if k != "params"},
           "vocabs_equal": a["vocabs"] == b["vocabs"],
           "text_equal": a["text"] == b["text"],
           "keep_equal": a["keep"] == b["keep"],
           "checked_cols": len(a["keep"][0]),
           "fill_max_rel_err": fill_err, "fill_rtol": OOC_FILL_RTOL,
           "nb_max_abs_err": nb_err, "nb_tol": OOC_NB_TOL,
           "aupr_gap": abs(ch["holdout_aupr"] - inc["holdout_aupr"]),
           "base_rate": base_rate, "attainable_aupr": attainable,
           "aupr_floor": floor,
           "aupr_share_of_attainable": ch["holdout_aupr"] / attainable}
    check(a["vocabs"] == b["vocabs"] and a["text"] == b["text"],
          "out_of_core a: vocabularies differ between the modes")
    check(a["keep"] == b["keep"], "out_of_core a: keep lists differ")
    check(fill_err <= OOC_FILL_RTOL,
          f"out_of_core a: fills part by {fill_err} relative")
    check(nb_err <= OOC_NB_TOL,
          f"out_of_core a: naive Bayes parameters part by {nb_err}")
    check(inc["finite"] and ch["finite"],
          "out_of_core a: non-finite probabilities")
    check(leg["aupr_gap"] <= OOC_AUPR_GAP,
          f"out_of_core a: holdout AuPRs {ch['holdout_aupr']} and "
          f"{inc['holdout_aupr']} part by more than {OOC_AUPR_GAP}")
    for m in (inc, ch):
        check(m["holdout_aupr"] >= floor,
              f"out_of_core a: {m['mode']} holdout AuPR "
              f"{m['holdout_aupr']} below {floor}")
    check(ch["rss_delta_bytes"] < inc["rss_delta_bytes"],
          f"out_of_core a: the chunked RSS delta {ch['rss_delta_bytes']} "
          f"is not below the in-core {inc['rss_delta_bytes']}")
    check(not ch["not_streamed"],
          f"out_of_core a: fitted in-core: {ch['not_streamed']}")
    return leg


def _ooc_rows(cols: dict, lo: int, hi: int, shift: bool = False) -> list:
    """Rows ``lo``..``hi`` as a client sends them (no label; missing
    values None); with ``shift`` Fare x 3 and Sex flipped."""
    names = [k for k in cols if k != "Survived"]
    lists = {k: cols[k][lo:hi].tolist() for k in names}
    out = []
    for i in range(hi - lo):
        r = {k: (None if (v[i] is None or v[i] != v[i]) else v[i])
             for k, v in lists.items()}
        if shift:
            r["Fare"] = r["Fare"] * 3
            r["Sex"] = "male" if r["Sex"] == "female" else "female"
        out.append(r)
    return out


def _ooc_leg_c(model, cols: dict, rows: int, tmp: str) -> dict:
    """Leg b's chunked model saved, loaded and served with a drift
    monitor: the first OOC_DRIFT_ROWS holdout rows unchanged, then the
    next ones shifted, each one request (one window); batch-1 latency
    with and without the monitor."""
    from transmogrifai_tpu_torch.serving.drift import (DriftConfig,
                                                       DriftMonitor)

    path = os.path.join(tmp, "ooc_model")
    model.save(path)
    loaded = OpWorkflowModel.load(path)
    n = OOC_DRIFT_ROWS
    clean = _ooc_rows(cols, rows, rows + n)
    shifted = _ooc_rows(cols, rows + n, rows + 2 * n, shift=True)
    # a window's rows come as one request, past the default queue bound
    srv = ModelServer.from_path(path, name="ooc", warmup_row=clean[0],
                                max_queue_rows=2 * n)
    mon = DriftMonitor.from_model(loaded, DriftConfig(min_rows=n))
    out = {"baselines": sorted(mon.baselines)}
    with srv:
        lat = {}
        for key in ("without_monitor", "with_monitor"):
            srv.drift_monitor = (None if key == "without_monitor" else
                                 DriftMonitor.from_model(
                                     loaded, DriftConfig(min_rows=200)))
            times = []
            for r in clean[:OOC_LATENCY_REQUESTS]:
                t0 = time.perf_counter()
                srv.score([r])
                times.append(time.perf_counter() - t0)
            lat[key] = _pcts(times)
        srv.with_drift_monitor(mon)
        t0 = time.perf_counter()
        scored = srv.score(clean, wait_s=300.0)
        clean_s = time.perf_counter() - t0
        clean_eval = mon.last_evaluation
        srv.score(shifted, wait_s=300.0)
        shifted_eval = mon.last_evaluation
        snap = srv.snapshot()
    # the same clean rows observed one by one (requests of one row): the
    # window histograms then keep a centroid per request for each
    # repeated value, which bends the integral columns' CDFs
    one = DriftMonitor.from_model(loaded, DriftConfig(min_rows=n))
    for r in clean:
        one.observe_rows([r])
    out.update({
        "clean_psi": {k: v["psi"] for k, v in
                      clean_eval["features"].items()},
        "clean_drifted": clean_eval["driftedFeatures"],
        "shifted_drifted": shifted_eval["driftedFeatures"],
        "shifted_psi": {k: v["psi"] for k, v in
                        shifted_eval["features"].items()},
        "refresh_triggered": mon.refresh_triggered,
        "clean_request_s": clean_s, "window_rows": n,
        "batch1_clean_drifted": one.last_evaluation["driftedFeatures"],
        "latency_batch1": lat, "snapshot_drift": "drift" in snap})
    name = model.result_features[0].name
    check(len(scored) == n and all(
        np.isfinite(s[name]["probability_1"]) for s in scored),
          "out_of_core c: the served clean rows are not all scored")
    check(not clean_eval["driftedFeatures"],
          f"out_of_core c: unchanged rows drift on "
          f"{clean_eval['driftedFeatures']}")
    check(mon.refresh_triggered and {"Fare", "Sex"} <= set(
        shifted_eval["driftedFeatures"]),
          f"out_of_core c: the shifted rows drift on "
          f"{shifted_eval['driftedFeatures']}, refresh "
          f"{mon.refresh_triggered}")
    check(out["snapshot_drift"], "out_of_core c: no drift in the snapshot")
    return out


def phase_out_of_core(rows: int, holdout: int, reps: int, bw: float,
                      f32: float) -> dict:
    """The out-of-core train on the card (the module docstring's phase
    6e): the Titanic columns with two planted features written to CSV;
    leg a (bench_ingest's DAG, in-core and chunked, each in a child),
    leg b (RawFeatureFilter, the streamed prefix and the default selector
    as the in-core tail, chunked and in-core in this process) and leg c
    (the drift monitor behind a server)."""
    phase_t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="tmog_ooc_")
    try:
        t0 = time.perf_counter()
        cols, p = ooc_columns(rows + holdout)
        train_csv = os.path.join(tmp, "train.csv")
        hold_csv = os.path.join(tmp, "holdout.csv")
        write_ooc_csv(train_csv, cols, 0, rows)
        write_ooc_csv(hold_csv, cols, rows, rows + holdout)
        data = {"seconds": time.perf_counter() - t0,
                "bytes": os.path.getsize(train_csv)
                + os.path.getsize(hold_csv)}
        y_hold = torch.as_tensor(cols["Survived"][rows:rows + holdout],
                                 dtype=torch.float32)
        attainable = aupr(y_hold, torch.from_numpy(
            p[rows:rows + holdout].astype(np.float32)))
        base_rate = float(y_hold.mean())
        train_a_csv = os.path.join(tmp, "train_a.csv")
        write_ooc_csv(train_a_csv, cols, 0, rows // OOC_A_ROWS_CUT)
        leg_a = _ooc_leg_a(train_a_csv, hold_csv, base_rate, attainable)
        os.remove(train_a_csv)

        # -- leg b: the filter, the streamed prefix, the selector tail ----
        hold_reader = CSVReader(hold_csv)
        legs = {}
        for mode, chunk_rows in (("chunked", OOC_SELECTOR_CHUNK_ROWS),
                                 ("in_core", None)):
            pred, checked, sel = build_ooc_selector()
            wf = (OpWorkflow().set_result_features(pred)
                  .set_reader(CSVReader(train_csv))
                  .with_raw_feature_filter(scoring_data=hold_reader))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            gk.seg_level_hists.launches = 0
            t0 = time.perf_counter()
            model = wf.train(chunk_rows=chunk_rows)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            launches = gk.seg_level_hists.launches
            hold = hold_reader.generate_dataset(model.raw_features())
            proba = model.score(hold)[pred.name].values.probability
            summ = sel.metadata["model_selector_summary"]
            legs[mode] = dict(
                model=model, checked=checked, sel=sel, train_s=train_s,
                tail=_not_streamed(pred, model),
                launches=launches, peak=torch.cuda.max_memory_allocated(),
                aupr=aupr(y_hold.to(proba.device), proba[:, 1]),
                finite=bool(torch.isfinite(proba).all()),
                winner=[summ["bestModelType"], summ["bestModelParams"]],
                dropped=model.raw_feature_filter_results.dropped_features,
                keep=[m.keep_indices for m in _stage_of(
                    model, "SanityCheckerModel")],
                names=model.train_data[checked.name].vmeta.column_names())
            del hold, proba
        ch, inc = legs["chunked"], legs["in_core"]
        ip = ch["model"].ingest_profile
        tail = ch["tail"]
        streamed = sorted(type(s).__name__ for s in ch["model"].stages
                          if s.uid in ch["model"].fit_states)
        sel_name = type(ch["sel"]).__name__
        X = ch["model"].train_data[ch["checked"].name].values
        y = np.asarray(ch["model"].train_data["Survived"].values,
                       np.float32)
        kernel_row = _titanic_levels(X, y, int(np.sqrt(X.shape[1])), reps,
                                     bw, f32)
        kernel_row["path"] = "out_of_core"
        del X
        leg_b = {
            "chunk_rows": OOC_SELECTOR_CHUNK_ROWS,
            "train_s": {m: legs[m]["train_s"] for m in legs},
            "max_memory_allocated": {m: legs[m]["peak"] for m in legs},
            "rff": ip.rff, "passes": [
                {"label": q.label, "chunks": q.chunks, "rows": q.rows,
                 "wall_s": q.wall_s, "read_s": q.read_s,
                 "transform_s": q.transform_s,
                 "overlap_efficiency": q.overlap_efficiency}
                for q in ip.passes],
            "spilled_mb": ip.spilled_bytes / 1e6,
            "tail_s": ch["model"].stage_seconds[sel_name],
            "stage_seconds": ch["model"].stage_seconds,
            "streamed": streamed, "tail": tail,
            "dropped": {m: legs[m]["dropped"] for m in legs},
            "checked_cols": len(ch["names"]),
            "checked_equal": ch["names"] == inc["names"]
            and ch["keep"] == inc["keep"],
            "winner": {m: legs[m]["winner"] for m in legs},
            "holdout_aupr": {m: legs[m]["aupr"] for m in legs},
            "attainable_aupr": attainable,
            "aupr_floor": OOC_AUPR_SHARE * attainable,
            "seg_hist_launches": ch["launches"],
            "forest_levels": ch["sel"].metadata["hist_levels"],
            "in_core_launches": inc["launches"],
            "group_errors": ch["sel"].metadata["group_errors"]}
        for m in legs:
            check(legs[m]["dropped"] == ["leak", "rare"],
                  f"out_of_core b: the {m} filter dropped "
                  f"{legs[m]['dropped']}")
            check(legs[m]["finite"] and legs[m]["aupr"]
                  >= OOC_AUPR_SHARE * attainable,
                  f"out_of_core b: {m} holdout AuPR {legs[m]['aupr']} "
                  f"below {OOC_AUPR_SHARE} x {attainable}")
        check(leg_b["checked_equal"],
              "out_of_core b: the checked columns differ between modes")
        check(ch["winner"] == inc["winner"],
              f"out_of_core b: winners {ch['winner']} and {inc['winner']}")
        check(abs(ch["aupr"] - inc["aupr"]) <= OOC_AUPR_GAP,
              f"out_of_core b: holdout AuPRs {ch['aupr']} and "
              f"{inc['aupr']} part by more than {OOC_AUPR_GAP}")
        check(tail == [sel_name],
              f"out_of_core b: fitted in-core: {tail}, not the selector "
              f"alone")
        check(not leg_b["group_errors"],
              f"out_of_core b: grid groups failed: {leg_b['group_errors']}")
        check(ch["launches"] > 0 and ch["launches"] == leg_b["forest_levels"],
              f"out_of_core b: seg_hist launches {ch['launches']} != the "
              f"forests' {leg_b['forest_levels']} levels")
        check(kernel_row["bitwise_equal"] and kernel_row["levels_checked"]
              > 0, f"out_of_core b: {kernel_row['levels_unequal']} of "
              f"{kernel_row['levels_checked']} levels differ from the plain "
              f"version")
        model = ch["model"]
        del legs, ch, inc
        torch.cuda.empty_cache()
        leg_c = _ooc_leg_c(model, cols, rows, tmp)
        del model
        torch.cuda.empty_cache()
        leg_d, ref = _ooc_leg_d(cols, rows, tmp)
        phase_s = time.perf_counter() - phase_t0
        emit(kernel_row)
        # the refresh_cv phase, on leg d's CSVs and its uninterrupted
        # train's states (the out_of_core line follows it)
        rcv_launches = phase_refresh_cv(cols, tmp, ref)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "out_of_core", "rows": rows, "holdout": holdout,
          "data": data, "a": leg_a, "b": leg_b, "c": leg_c, "d": leg_d,
          "phase_s": phase_s})
    return {"seg_hist_launches": leg_b["seg_hist_launches"]
            + sum(leg_d["seg_hist_launches"].values()),
            "refresh_cv_launches": rcv_launches}


# ---------------------------------------------------------------------------
# the refresh_cv phase: streaming workflow CV, warm-start refresh, the tuner
# ---------------------------------------------------------------------------

def _state_diffs(a, b, rtol: float, path: str = "", out=None) -> list:
    """Where two exported fit states differ: structure, integers and
    strings exactly, floats within ``rtol`` (NaNs equal), a sketch by its
    ``to_state``; at most 10 paths."""
    out = [] if out is None else out
    if len(out) >= 10:
        return out
    if hasattr(a, "to_state") and hasattr(b, "to_state"):
        return _state_diffs(a.to_state(), b.to_state(), rtol, path, out)
    if isinstance(a, np.random.Generator):
        if a.bit_generator.state != b.bit_generator.state:
            out.append(f"{path}: generator state")
        return out
    if hasattr(a, "to_json") and hasattr(b, "to_json"):
        return _state_diffs(a.to_json(), b.to_json(), rtol, path, out)
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    if isinstance(b, torch.Tensor):
        b = b.cpu().numpy()
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            out.append(f"{path}: keys {sorted(map(str, set(a) ^ set(b)))}")
            return out
        for k in a:
            _state_diffs(a[k], b[k], rtol, f"{path}.{k}", out)
        return out
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            out.append(f"{path}: {len(a)} items against {len(b)}")
            return out
        for i, (x, y) in enumerate(zip(a, b)):
            _state_diffs(x, y, rtol, f"{path}[{i}]", out)
        return out
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        if a.shape != b.shape:
            out.append(f"{path}: shapes {a.shape} and {b.shape}")
        elif a.dtype.kind in "fc":
            if not np.allclose(a, b, rtol=rtol, atol=0.0, equal_nan=True):
                rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-300)
                out.append(f"{path}: max rel {float(np.nanmax(rel))}")
        elif not np.array_equal(a, b):
            out.append(f"{path}: arrays differ")
        return out
    if isinstance(a, float) and isinstance(b, float):
        if not (a == b or (a != a and b != b)
                or abs(a - b) <= rtol * abs(b)):
            out.append(f"{path}: {a!r} against {b!r}")
        return out
    if a != b:
        out.append(f"{path}: {a!r} against {b!r}")
    return out


def _rcv_train(train_csv: str, hold_csv: str, chunk_rows, cv: bool = False,
               tuner=None, profile: bool = False,
               models_and_parameters=None):
    """Leg d's DAG (the filter, the ten predictors and the planted ones,
    SanityChecker, the default binary selector, or one over
    ``models_and_parameters``) from ``train_csv``, its stages numbered
    from 1 as leg d's are: (workflow, model, prediction, selector, wall
    seconds, seg_hist launches)."""
    from transmogrifai_tpu_torch.utils.uid import reset_uids

    reset_uids()
    pred, _, sel = build_ooc_selector(models_and_parameters)
    wf = (OpWorkflow().set_result_features(pred)
          .set_reader(CSVReader(train_csv))
          .with_raw_feature_filter(scoring_data=CSVReader(hold_csv)))
    if cv:
        wf.with_workflow_cv()
    torch.cuda.synchronize()
    gk.seg_level_hists.launches = 0
    t0 = time.perf_counter()
    model = wf.train(chunk_rows=chunk_rows, tuner=tuner, profile=profile)
    torch.cuda.synchronize()
    return (wf, model, pred, sel, time.perf_counter() - t0,
            gk.seg_level_hists.launches)


def _rcv_holdout(model, pred, hold_csv: str):
    """(holdout probabilities, AuPR) of a model."""
    hold = CSVReader(hold_csv).generate_dataset(model.raw_features())
    proba = model.score(hold)[pred.name].values.probability
    y = torch.as_tensor(np.asarray(hold["Survived"].values, np.float32))
    return proba, aupr(y.to(proba.device), proba[:, 1])


def _rcv_leg_a(cols: dict, tmp: str, hold_csv: str) -> Tuple[dict, str]:
    """Streaming workflow CV: RCV_CV_ROWS of leg d's rows under
    with_workflow_cv(), chunked (RCV_CHUNK_ROWS) and in core; the fold ids
    the chunked train assigned against those the in-core validator draws,
    the winners, the fold metrics and the holdout AuPRs."""
    from transmogrifai_tpu_torch.workflow import streaming_cv

    csv_a = os.path.join(tmp, "rcv_a.csv")
    write_ooc_csv(csv_a, cols, 0, RCV_CV_ROWS)
    seen = {}
    assign = streaming_cv.StreamingCVContext.assign_folds

    def spy(ctx):
        assign(ctx)
        seen["folds"] = ctx._global_folds.copy()

    streaming_cv.StreamingCVContext.assign_folds = spy
    try:
        _, mc, pred_c, sel_c, wall_c, launches_c = _rcv_train(
            csv_a, hold_csv, RCV_CHUNK_ROWS, cv=True)
    finally:
        streaming_cv.StreamingCVContext.assign_folds = assign
    _, mi, pred_i, sel_i, wall_i, launches_i = _rcv_train(
        csv_a, hold_csv, None, cv=True)
    # the in-core validator's folds over the same labels
    y = np.nan_to_num(np.asarray(cols["Survived"][:RCV_CV_ROWS],
                                 np.float64))
    _, mask, _, _ = sel_i._split(y)
    train_idx = np.flatnonzero(mask)
    v = sel_i.validator
    expected = np.full(len(y), -1, np.int32)
    expected[train_idx] = make_folds(len(train_idx), v.num_folds,
                                     y=y[train_idx], stratify=v.stratify,
                                     seed=v.seed)
    res_c = sel_c.metadata["workflow_cv_results"]
    res_i = sel_i.metadata["workflow_cv_results"]
    gaps = [abs(a - b) for rc, ri in zip(res_c, res_i)
            for a, b in zip(rc["foldValues"], ri["foldValues"])]
    tol = SanityChecker().streaming_fit_tol
    p_c, aupr_c = _rcv_holdout(mc, pred_c, hold_csv)
    p_i, aupr_i = _rcv_holdout(mi, pred_i, hold_csv)
    win = {m: [s.metadata["model_selector_summary"]["bestModelType"],
               s.metadata["model_selector_summary"]["bestModelParams"]]
           for m, s in (("chunked", sel_c), ("in_core", sel_i))}
    leg = {"rows": RCV_CV_ROWS, "chunk_rows": RCV_CHUNK_ROWS,
           "wall_s": {"chunked": wall_c, "in_core": wall_i},
           "seg_hist_launches": {"chunked": launches_c,
                                 "in_core": launches_i},
           "passes": [q.label for q in mc.ingest_profile.passes],
           "fold_ids_equal": bool("folds" in seen
                                  and np.array_equal(seen["folds"],
                                                     expected)),
           "fold_sizes": np.bincount(expected[expected >= 0]).tolist(),
           "winner": win, "candidates": len(res_c),
           "fold_metric_max_abs_gap": max(gaps) if gaps else None,
           "fold_metric_tol": tol,
           "holdout_aupr": {"chunked": aupr_c, "in_core": aupr_i},
           "aupr_gap": abs(aupr_c - aupr_i), "aupr_gap_max": SO_CV_AUPR_GAP,
           "elastic": sel_c.metadata.get("workflow_cv_elastic")}
    check(leg["fold_ids_equal"],
          "refresh_cv a: the chunked train's fold ids differ from the "
          "in-core validator's")
    check(win["chunked"] == win["in_core"],
          f"refresh_cv a: winners {win['chunked']} and {win['in_core']}")
    check(len(res_c) == len(res_i) and gaps and max(gaps) <= tol,
          f"refresh_cv a: fold metrics part by "
          f"{leg['fold_metric_max_abs_gap']} (tolerance {tol})")
    check(bool(torch.isfinite(p_c).all() and torch.isfinite(p_i).all())
          and leg["aupr_gap"] <= SO_CV_AUPR_GAP,
          f"refresh_cv a: holdout AuPRs {aupr_c} and {aupr_i}")
    check(launches_c > 0 and launches_i > 0,
          f"refresh_cv a: seg_hist launches {launches_c}, {launches_i}")
    return leg, csv_a


def _rcv_leg_b(cols: dict, tmp: str, ref: dict) -> dict:
    """Warm-start refresh: leg d's first RCV_BASE_ROWS rows trained
    chunked, saved and loaded, refreshed with the rest of its rows; the
    merged states against leg d's uninterrupted train's, and a second
    refresh from the same base bitwise."""
    hold_csv = ref["hold_csv"]
    base_csv = os.path.join(tmp, "rcv_base.csv")
    new_csv = os.path.join(tmp, "rcv_new.csv")
    write_ooc_csv(base_csv, cols, 0, RCV_BASE_ROWS)
    write_ooc_csv(new_csv, cols, RCV_BASE_ROWS, OOC_CKPT_ROWS)
    wf, base, pred, _, wall_base, launches_base = _rcv_train(
        base_csv, hold_csv, RCV_CHUNK_ROWS)
    path = os.path.join(tmp, "rcv_model")
    t0 = time.perf_counter()
    base.save(path)
    loaded = OpWorkflowModel.load(path)
    save_load_s = time.perf_counter() - t0
    loaded_diffs = [d for uid in base.fit_states for d in _state_diffs(
        loaded.fit_states.get(uid), base.fit_states[uid], 0.0, uid)]
    refreshes = []
    for _ in range(2):
        torch.cuda.synchronize()
        gk.seg_level_hists.launches = 0
        t0 = time.perf_counter()
        r = wf.refresh(loaded, data=CSVReader(new_csv),
                       chunk_rows=RCV_CHUNK_ROWS)
        torch.cuda.synchronize()
        refreshes.append((r, time.perf_counter() - t0,
                          gk.seg_level_hists.launches))
    (r1, wall1, launches1), (r2, wall2, launches2) = refreshes
    report = r1.refresh_report
    merged_diffs = {uid: _state_diffs(r1.fit_states[uid],
                                      ref["fit_states"][uid],
                                      RCV_STATE_RTOL, uid)
                    for uid in report["merged"]}
    p1, aupr1 = _rcv_holdout(r1, pred, hold_csv)
    p2, _ = _rcv_holdout(r2, pred, hold_csv)
    leg = {"base_rows": RCV_BASE_ROWS,
           "new_rows": OOC_CKPT_ROWS - RCV_BASE_ROWS,
           "chunk_rows": RCV_CHUNK_ROWS,
           "base_train_s": wall_base, "save_load_s": save_load_s,
           "fit_states": len(base.fit_states),
           "loaded_states_equal": not loaded_diffs,
           "refresh_s": [wall1, wall2], "report": report,
           "dropped": base.raw_feature_filter_results.dropped_features,
           "passes": [q.label for q in r1.ingest_profile.passes],
           "merged_states_equal": {uid: not d
                                   for uid, d in merged_diffs.items()},
           "state_rtol": RCV_STATE_RTOL,
           "second_refresh_bitwise": bool(torch.equal(p1, p2)),
           "holdout_aupr": aupr1,
           "seg_hist_launches": {"base": launches_base,
                                 "refreshes": [launches1, launches2]}}
    check(set(loaded.fit_states) == set(base.fit_states)
          and not loaded_diffs,
          f"refresh_cv b: fit states lost or changed in save and load: "
          f"{loaded_diffs[:3]}")
    check(leg["dropped"] == ref["dropped"],
          f"refresh_cv b: the base train dropped {leg['dropped']}, leg d "
          f"{ref['dropped']}")
    check(report["merged"] and not report["refit"],
          f"refresh_cv b: the refresh merged nothing: {report}")
    bad = {uid: d for uid, d in merged_diffs.items() if d}
    check(not bad, f"refresh_cv b: merged states differ from the "
                   f"uninterrupted train's: {bad}")
    check(leg["second_refresh_bitwise"] and bool(torch.isfinite(p1).all()),
          "refresh_cv b: a second refresh from the same base differs")
    check(launches1 > 0 and launches2 > 0,
          f"refresh_cv b: seg_hist launches {launches1}, {launches2}")
    return leg


def _rcv_leg_c(cols: dict, tmp: str, hold_csv: str, csv_a: str) -> dict:
    """The tuner and the profile: train(tuner=Tuner(strategy="halving",
    auto_plan=True, host_budget_bytes=RCV_TUNER_BUDGET), profile=True) on
    RCV_TUNER_ROWS rows; then the plan's host pool: in-core trains with
    TMOG_PLAN_WORKERS=1 and with the default, bitwise equal (the DAG's
    host stages are the pool's; its selector, serial on the card either
    way, holds an LR grid, ``_lr_grid``)."""
    from transmogrifai_tpu_torch.tuning import Tuner

    csv_c = csv_a
    if RCV_TUNER_ROWS != RCV_CV_ROWS:
        csv_c = os.path.join(tmp, "rcv_c.csv")
        write_ooc_csv(csv_c, cols, 0, RCV_TUNER_ROWS)
    tuner = Tuner(strategy="halving", auto_plan=True,
                  host_budget_bytes=RCV_TUNER_BUDGET)
    wf, model, pred, sel, wall, launches = _rcv_train(
        csv_c, hold_csv, None, tuner=tuner, profile=True)
    advice = wf._plan_advice(tuner)
    prof = model.train_profile
    top = sorted(prof.stages, key=lambda s: -s.wall_s)[:8]
    prof_launches = sum(s.launches for s in prof.stages)
    _, aupr_t = _rcv_holdout(model, pred, hold_csv)
    pool = {}
    for mode, workers in (("serial", "1"), ("pool", None)):
        prev = os.environ.pop("TMOG_PLAN_WORKERS", None)
        if workers is not None:
            os.environ["TMOG_PLAN_WORKERS"] = workers
        try:
            _, m, p, _, w, n = _rcv_train(
                csv_c, hold_csv, None,
                models_and_parameters=_lr_grid())
        finally:
            os.environ.pop("TMOG_PLAN_WORKERS", None)
            if prev is not None:
                os.environ["TMOG_PLAN_WORKERS"] = prev
        pool[mode] = (w, n, _rcv_holdout(m, p, hold_csv)[0])
    from transmogrifai_tpu_torch.workflow.plan import _plan_workers

    ip = model.ingest_profile
    leg = {"rows": RCV_TUNER_ROWS, "advice": advice.to_json(),
           "streamed": ip is not None,
           "chunk_rows": ip.chunk_rows if ip is not None else None,
           "wall_s": wall, "seg_hist_launches": launches,
           "profiled_launches": prof_launches,
           "strategy_restored": sel.strategy == "full",
           "halving_rungs": len(sel.metadata.get("halving_schedule", {})
                                .get("rungs", [])),
           "top_stages": [{"op": s.op, "kind": s.kind, "wall_s": s.wall_s,
                           "launches": s.launches, "rows": s.rows,
                           "cols": s.cols} for s in top],
           "profiled_stages": len(prof.stages),
           "holdout_aupr": aupr_t,
           "pool_workers": _plan_workers(),
           "pool_wall_s": {k: v[0] for k, v in pool.items()},
           "pool_seg_hist_launches": {k: v[1] for k, v in pool.items()},
           "pool_bitwise": bool(torch.equal(pool["serial"][2],
                                            pool["pool"][2]))}
    check(advice.mode == "stream" and leg["streamed"]
          and leg["chunk_rows"] == advice.chunk_rows,
          f"refresh_cv c: the planner's advice {advice.to_json()} was not "
          f"taken")
    check(leg["strategy_restored"] and leg["halving_rungs"] > 0,
          "refresh_cv c: the tuner's halving did not run or was not "
          "restored")
    check(launches > 0 and prof_launches == launches,
          f"refresh_cv c: the profile's launches {prof_launches} against "
          f"the train's {launches}")
    check(leg["pool_bitwise"],
          "refresh_cv c: the pooled and serial plans' probabilities differ")
    return leg


def phase_refresh_cv(cols: dict, tmp: str, ref: dict) -> int:
    """Streaming workflow CV, the warm-start refresh and the tuner on the
    card (the module docstring's phase 6e'), in this process, on
    out_of_core leg d's rows; returns the seg_hist launches of its
    trains."""
    phase_t0 = time.perf_counter()
    t0 = time.perf_counter()
    leg_a, csv_a = _rcv_leg_a(cols, tmp, ref["hold_csv"])
    a_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    leg_b = _rcv_leg_b(cols, tmp, ref)
    b_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    leg_c = _rcv_leg_c(cols, tmp, ref["hold_csv"], csv_a)
    c_s = time.perf_counter() - t0
    emit({"phase": "refresh_cv", "a": leg_a, "b": leg_b, "c": leg_c,
          "leg_s": {"a": a_s, "b": b_s, "c": c_s},
          "phase_s": time.perf_counter() - phase_t0,
          "predicted": REFRESH_CV_PREDICTED})
    return (sum(leg_a["seg_hist_launches"].values())
            + leg_b["seg_hist_launches"]["base"]
            + sum(leg_b["seg_hist_launches"]["refreshes"])
            + leg_c["seg_hist_launches"]
            + sum(leg_c["pool_seg_hist_launches"].values()))


# ---------------------------------------------------------------------------
# the events phase: event-time AutoML on a JSONL clickstream
# ---------------------------------------------------------------------------

_EV_PAGES = ("home", "search", "product", "checkout")
_EV_UAS = tuple(f"Mozilla/5.0 (dev-{i}; rv:{100 + i}) Gecko/2026 shop/{i}.0"
                for i in range(24))


def make_clickstream(path: str, n_users: int, seed: int = EV_SEED,
                     rate: float = 1.0, bad_lines=()) -> int:
    """examples/bench_events.py's JSONL event log (the same fields and
    per-user distributions: half the users engaged, 6-17 events plus 8
    for the engaged, scaled by ``rate``, 1-11 hours apart, pages 30/30/30/
    10%, gamma dwell doubled for the engaged, and an order an hour after
    the last event for 80% of the engaged users who saw checkout), drawn
    vectorised with numpy (the draws differ from the script's
    per-event ``rng.choice``).  ``bad_lines`` are record ordinals written
    as invalid JSON instead.  Returns the records written."""
    rng = np.random.default_rng(seed)
    engaged = rng.random(n_users) < 0.5
    start = rng.integers(0, 30, n_users) * DAY
    n_ev = ((rng.integers(6, 18, n_users) + 8 * engaged) * rate).astype(
        np.int64)
    ua = rng.integers(0, len(_EV_UAS), n_users)
    n = int(n_ev.sum())
    user = np.repeat(np.arange(n_users), n_ev)
    first = np.cumsum(n_ev) - n_ev
    seq = np.arange(n) - np.repeat(first, n_ev)
    gaps = rng.integers(1, 12, n) * HOUR
    cum = np.cumsum(gaps)
    t = start[user] + cum - np.repeat(cum[first] - gaps[first], n_ev)
    page = rng.choice(4, n, p=[0.3, 0.3, 0.3, 0.1])
    dwell = np.round(rng.gamma(2.0, 20.0, n) * (1.0 + engaged[user]), 6)
    cid = rng.integers(0, 9999, n)
    saw = np.bincount(user, weights=page == 3, minlength=n_users) > 0
    buys = np.flatnonzero(saw & engaged & (rng.random(n_users) < 0.8))
    last_t = t[first + n_ev - 1]
    lines = [
        f'{{"user": "u{u}", "time": {tt}, "page": "{_EV_PAGES[p]}", '
        f'"dwell_s": {d!r}, "purchase": 0.0, "session": '
        f'"s-{u}-{i // 6}-{tt % DAY:08d}", "referrer": '
        f'"https://shop.example.com/{_EV_PAGES[p]}?cid=c{c:04d}'
        f'&src=organic", "ua": "{_EV_UAS[a]}"}}'
        for u, tt, p, d, i, c, a in zip(
            user.tolist(), t.tolist(), page.tolist(), dwell.tolist(),
            seq.tolist(), cid.tolist(), ua[user].tolist())]
    for u in buys.tolist()[::-1]:
        tt = int(last_t[u]) + HOUR
        lines.insert(int(first[u] + n_ev[u]), (
            f'{{"user": "u{u}", "time": {tt}, "page": "order", '
            f'"dwell_s": 30.0, "purchase": 1.0, "session": '
            f'"s-{u}-{int(n_ev[u]) // 6}-{tt % DAY:08d}", "referrer": '
            f'"https://shop.example.com/order", "ua": "{_EV_UAS[ua[u]]}"}}'))
    for i in bad_lines:
        lines[i] = '{"user": "u0", "time": ' + "}" * 3
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return len(lines)


def _ev_user(r):
    return r["user"]


def _ev_time(r):
    return r["time"]


def _ev_is_checkout(r):
    return r["page"] == "checkout"


def events_reader(source, streamed: bool = True, cutoff: bool = True,
                  ns=None):
    """bench_events.py's reader over ``source``: each user's cutoff at
    their first checkout visit, predictors over the 30 days before it, the
    response over the day after.  ``streamed``: a
    ``StreamingConditionalReader`` over a JSON-lines path, else a
    ``ConditionalDataReader`` over parsed records; without ``cutoff`` a
    leaky ``StreamingAggregateReader`` that declares none.  ``ns``: the
    package's reader classes (the port's by default)."""
    ns = ns or _port_events_ns()
    if not cutoff:
        return ns["StreamingAggregateReader"](
            ns["JSONLinesReader"](source), key_fn=_ev_user,
            time_fn=_ev_time, cutoff=ns["CutOffTime"].no_cutoff())
    kw = dict(key_fn=_ev_user, time_fn=_ev_time,
              target_condition=_ev_is_checkout,
              predictor_window_ms=30 * DAY, response_window_ms=DAY)
    if streamed:
        return ns["StreamingConditionalReader"](ns["JSONLinesReader"](source),
                                                **kw)
    return ns["ConditionalDataReader"](source, **kw)


def _port_events_ns() -> dict:
    from transmogrifai_tpu_torch.aggregators import CutOffTime
    from transmogrifai_tpu_torch.readers import (
        ConditionalDataReader, JSONLinesReader, StreamingAggregateReader,
        StreamingConditionalReader)

    return {"FeatureBuilder": FeatureBuilder, "transmogrify": transmogrify,
            "SanityChecker": SanityChecker,
            "BinaryClassificationModelSelector":
                BinaryClassificationModelSelector,
            "CutOffTime": CutOffTime,
            "ConditionalDataReader": ConditionalDataReader,
            "JSONLinesReader": JSONLinesReader,
            "StreamingAggregateReader": StreamingAggregateReader,
            "StreamingConditionalReader": StreamingConditionalReader}


def build_events(ns=None, models_and_parameters=None):
    """The events DAG (examples/op_event_aggregation.py's and
    bench_events.py's features): n_events, total_dwell and n_checkout
    (sumNumeric), pages_seen (MultiPickList), purchased (maxBoolean) ->
    transmogrify -> SanityChecker -> the default binary selector (or
    ``models_and_parameters``).  Returns (prediction, checked, selector)."""
    ns = ns or _port_events_ns()
    FB = ns["FeatureBuilder"]
    visits = (FB.Integral("n_events").extract(lambda r: 1)
              .aggregate("sumNumeric").as_predictor())
    dwell = (FB.Real("total_dwell").extract(lambda r: r["dwell_s"])
             .aggregate("sumNumeric").as_predictor())
    checkouts = (FB.Integral("n_checkout")
                 .extract(lambda r: int(r["page"] == "checkout"),
                          event_field="page")
                 .aggregate("sumNumeric").as_predictor())
    pages = (FB.MultiPickList("pages_seen")
             .extract(lambda r: {r["page"]}, event_field="page")
             .as_predictor())
    bought = (FB.Binary("purchased")
              .extract(lambda r: bool(r["purchase"]),
                       event_field="purchase")
              .aggregate("maxBoolean").as_response())
    feats = ns["transmogrify"]([visits, dwell, checkouts, pages])
    checked = ns["SanityChecker"]().set_input(bought, feats).get_output()
    sel = ns["BinaryClassificationModelSelector"].with_cross_validation(
        models_and_parameters=models_and_parameters)
    return sel.set_input(bought, checked).get_output(), checked, sel


def events_child(train_jsonl: str, hold_jsonl: str, mode: str,
                 chunk_rows: int, out_npz: str) -> None:
    """Leg a's train in this process (each mode in a child of its own):
    the events DAG over the ``train_jsonl`` log, in-core (the record log
    parsed whole into a ``ConditionalDataReader``) or streamed
    (``StreamingConditionalReader`` with ``train(chunk_rows=)``); the
    holdout log scored.  Prints one JSON line; the holdout probabilities,
    the keys and (streamed) the checked matrix go to ``out_npz``."""
    dev = resolve_device()
    torch.zeros(1, device=dev)           # the CUDA context in the baseline
    # the libraries and kernels the train loads (cuBLAS, the solver, the
    # forests' code) resident before the baseline, as bench_events.py
    # warms its backend: a train of this mode on a small log
    warm_log = out_npz + ".warm.jsonl"
    make_clickstream(warm_log, EV_WARM_USERS, EV_HOLD_SEED + 10)
    warm, _, _ = build_events(models_and_parameters=[
        (OpLogisticRegression(), grid(reg_param=[0.1])),
        (OpRandomForestClassifier(), grid(num_trees=[2], max_depth=[3]))])
    with open(warm_log) as fh:
        warm_src = ([json.loads(line) for line in fh]
                    if mode == "in_core" else warm_log)
    (OpWorkflow().allow_non_serializable().set_result_features(warm)
     .set_reader(events_reader(warm_src, streamed=mode != "in_core"))
     .train(chunk_rows=chunk_rows if mode == "streamed" else None))
    del warm, warm_src
    gc.collect()
    pred, checked, sel = build_events()
    gk.seg_level_hists.launches = 0
    base_rss = _rss_bytes()
    torch.cuda.reset_peak_memory_stats()
    with _PeakRSS() as rss:
        t0 = time.perf_counter()
        if mode == "in_core":
            with open(train_jsonl) as fh:
                records = [json.loads(line) for line in fh]
            reader = events_reader(records, streamed=False)
        else:
            reader = events_reader(train_jsonl)
        parse_s = time.perf_counter() - t0
        wf = (OpWorkflow().allow_non_serializable()
              .set_result_features(pred).set_reader(reader))
        model = wf.train(chunk_rows=chunk_rows if mode == "streamed"
                         else None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = gk.seg_level_hists.launches
    peak_dev = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    hold = events_reader(hold_jsonl).generate_dataset(
        list(wf.raw_features()))
    scored, metrics = model.score_and_evaluate(
        Evaluators.BinaryClassification.auROC(), data=hold)
    score_s = time.perf_counter() - t0
    proba = scored[pred.name].values.probability[:, 1]
    td = model.train_data
    arrays = {"proba": proba.double().cpu().numpy(),
              "keys": np.asarray(td["key"].to_list(), dtype=str)}
    if mode == "streamed":
        arrays["X"] = td[checked.name].values.cpu().numpy()
        arrays["y"] = np.asarray(td["purchased"].values, np.float32)
    np.savez(out_npz, **arrays)
    summ = sel.metadata["model_selector_summary"]
    out = {"mode": mode, "wall_s": wall, "parse_s": parse_s,
           "rows": len(td), "holdout_rows": len(hold),
           "holdout_score_s": score_s,
           "baseline_rss_bytes": base_rss, "peak_rss_bytes": rss.peak,
           "rss_delta_bytes": rss.peak - base_rss,
           "max_memory_allocated": peak_dev,
           "holdout_auroc": metrics["AuROC"],
           "finite": bool(torch.isfinite(proba).all()),
           "winner": [summ["bestModelType"], summ["bestModelParams"]],
           "seg_hist_launches": launches,
           "forest_levels": sel.metadata["hist_levels"],
           "group_errors": sel.metadata["group_errors"],
           "checked_cols": int(td[checked.name].values.shape[1]),
           "stage_seconds": model.stage_seconds}
    ip = model.ingest_profile
    if ip is not None:
        out.update({"chunk_rows": chunk_rows, "passes": [
            {"label": p.label, "chunks": p.chunks, "rows": p.rows,
             "wall_s": p.wall_s, "read_s": p.read_s,
             "transform_s": p.transform_s, "rows_per_s": p.rows_per_s}
            for p in ip.passes]})
    print(json.dumps(out), flush=True)


def _run_events_child(train: str, hold: str, mode: str, chunk_rows: int,
                      out_npz: str) -> dict:
    cmd = [sys.executable, os.path.abspath(__file__), "--events-child",
           mode, "--events-train", train, "--events-holdout", hold,
           "--events-chunk-rows", str(chunk_rows), "--events-out", out_npz]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    check(proc.returncode == 0 and lines,
          f"events: the {mode} child failed (exit {proc.returncode}): "
          f"{proc.stderr[-2000:]}")
    return json.loads(lines[-1])


def _events_leg_a(tmp: str, reps: int, bw: float, f32: float):
    """The events DAG on EV_USERS users, in-core and streamed, each in a
    child; the guards of leg a; the widest forest level of the streamed
    model's checked matrix held bitwise to the plain version."""
    t0 = time.perf_counter()
    train = os.path.join(tmp, "train.jsonl")
    hold = os.path.join(tmp, "holdout.jsonl")
    n_train = make_clickstream(train, EV_USERS, EV_SEED)
    n_hold = make_clickstream(hold, EV_HOLD_USERS, EV_HOLD_SEED)
    data = {"seconds": time.perf_counter() - t0, "events": n_train,
            "holdout_events": n_hold, "bytes": os.path.getsize(train)}
    runs, arrays = {}, {}
    for mode, chunk_rows in (("in_core", 0), ("streamed", EV_CHUNK_ROWS)):
        npz = os.path.join(tmp, f"{mode}.npz")
        runs[mode] = _run_events_child(train, hold, mode, chunk_rows, npz)
        with np.load(npz) as z:
            arrays[mode] = {k: z[k] for k in z.files}
    inc, st = runs["in_core"], runs["streamed"]
    a, b = arrays["streamed"], arrays["in_core"]
    proba_err = float(np.abs(a["proba"] - b["proba"]).max())
    rss_ratio = st["rss_delta_bytes"] / max(inc["rss_delta_bytes"], 1)
    leg = {"data": data, "in_core": inc, "streamed": st,
           "keys_equal": bool(np.array_equal(a["keys"], b["keys"])),
           "proba_max_abs_err": proba_err, "proba_tol": EV_PROBA_TOL,
           "rss_ratio": rss_ratio, "rss_ratio_limit": EV_RSS_RATIO,
           "auroc_floor": EV_AUROC_FLOOR}
    emit({"phase": "events_a", **leg})
    check(inc["rows"] == st["rows"] and leg["keys_equal"],
          f"events a: rows {inc['rows']} and {st['rows']} or their keys "
          f"differ between the modes")
    check(inc["winner"] == st["winner"],
          f"events a: winners {inc['winner']} and {st['winner']}")
    check(proba_err <= EV_PROBA_TOL,
          f"events a: holdout probabilities part by {proba_err}")
    for m in (inc, st):
        check(m["finite"] and m["holdout_auroc"] >= EV_AUROC_FLOOR,
              f"events a: {m['mode']} holdout AuROC {m['holdout_auroc']} "
              f"below {EV_AUROC_FLOOR}")
        check(not m["group_errors"],
              f"events a: grid groups failed: {m['group_errors']}")
        check(m["seg_hist_launches"] > 0
              and m["seg_hist_launches"] == m["forest_levels"],
              f"events a: {m['mode']} seg_hist launches "
              f"{m['seg_hist_launches']} != the forests' "
              f"{m['forest_levels']} levels")
    check(rss_ratio < EV_RSS_RATIO,
          f"events a: the streamed RSS delta is {rss_ratio} x the "
          f"in-core one")
    X = torch.from_numpy(a["X"]).to("cuda")
    kernel_row = _titanic_levels(X, a["y"], max(1, int(np.sqrt(
        X.shape[1]))), reps, bw, f32)
    kernel_row["path"] = "events"
    check(kernel_row["bitwise_equal"] and kernel_row["levels_checked"] > 0,
          f"events: {kernel_row['levels_unequal']} of "
          f"{kernel_row['levels_checked']} levels differ from the plain "
          f"version")
    del X
    return leg, kernel_row


def _lr_grid():
    return [(OpLogisticRegression(), grid(reg_param=[0.01, 0.1]))]


def _ev_rows(ds, names) -> list:
    cols = [ds[n].to_list() for n in names]
    return list(zip(*cols))


def _events_leg_b(tmp: str) -> dict:
    """On EV_B_USERS users, with an LR grid: a log with EV_BAD_LINES
    corrupted lines under the quarantine policy, a transient IO error at
    ``event.window`` under a RetryPolicy, TM060 refusing a reader without
    a cutoff, and the drift monitor on a fresh and on a 3x-rate log."""
    from transmogrifai_tpu_torch.readers.resilience import RetryPolicy
    from transmogrifai_tpu_torch.serving.drift import (DriftConfig,
                                                       DriftMonitor)
    from transmogrifai_tpu_torch.utils import faults

    clean = os.path.join(tmp, "b_clean.jsonl")
    n = make_clickstream(clean, EV_B_USERS, EV_SEED)
    bad = np.linspace(n // 7, n - n // 7, EV_BAD_LINES).astype(int).tolist()
    dirty = os.path.join(tmp, "b_dirty.jsonl")
    make_clickstream(dirty, EV_B_USERS, EV_SEED, bad_lines=bad)
    kept = os.path.join(tmp, "b_kept.jsonl")
    dropped = set(bad)
    with open(clean) as src, open(kept, "w") as dst:
        dst.writelines(ln for i, ln in enumerate(src) if i not in dropped)

    def train(reader):
        pred, checked, sel = build_events(models_and_parameters=_lr_grid())
        wf = (OpWorkflow().allow_non_serializable()
              .set_result_features(pred).set_reader(reader))
        return wf, pred, wf.train(chunk_rows=EV_B_CHUNK_ROWS)

    # quarantine: each bad line once across the passes, the sidecar and
    # the aggregated rows reconciled with the log less those lines
    qpath = os.path.join(tmp, "quarantine.jsonl")
    qreader = events_reader(dirty).with_resilience(
        bad_records="quarantine", quarantine_path=qpath)
    wf, pred, qmodel = train(qreader)
    sink = qreader.resilience.sink()
    with open(qpath) as fh:
        entries = [json.loads(line) for line in fh]
    raw = [f for f in wf.raw_features()]
    names = ["key"] + [f.name for f in raw]
    q_rows = _ev_rows(qreader.generate_dataset(raw), names)
    k_rows = _ev_rows(events_reader(kept).generate_dataset(raw), names)
    quarantine = {
        "bad_lines": [i + 1 for i in bad], "sink_records": sink.count,
        "sink_rows": sink.rows, "sidecar_entries": len(entries),
        "passes": len(qmodel.ingest_profile.passes),
        "profile_quarantined": qmodel.ingest_profile.quarantined_records,
        "locations": [e["location"] for e in entries],
        "rows_reconcile": q_rows == k_rows, "rows": len(q_rows)}
    lines_seen = sorted(int(e["location"].split()[1]) for e in entries)
    check(sink.count == EV_BAD_LINES and sink.rows == EV_BAD_LINES
          and len(entries) == EV_BAD_LINES
          and lines_seen == quarantine["bad_lines"],
          f"events b: quarantine {quarantine}")
    check(quarantine["profile_quarantined"] == EV_BAD_LINES,
          f"events b: the ingest profile counts "
          f"{quarantine['profile_quarantined']} quarantined records")
    check(quarantine["rows_reconcile"],
          "events b: the quarantined reader's rows differ from the log's "
          "less the bad lines")

    # retry: an IO error at the second key-window chunk, retried
    hold = events_reader(clean).generate_dataset(raw)
    _, cpred, cmodel = train(events_reader(clean))
    clean_p = cmodel.score(hold)[cpred.name].values.probability[:, 1]
    pivot_checks(cmodel, hold, "events")
    rreader = events_reader(clean).with_resilience(
        retry=RetryPolicy(max_attempts=3, base_delay_s=0.0))
    with faults.inject(faults.FaultSpec(point="event.window",
                                        action="io_error", at=1,
                                        times=1)) as plan:
        _, rpred, rmodel = train(rreader)
    retry_p = rmodel.score(hold)[rpred.name].values.probability[:, 1]
    retry = {"fired": len(plan.log),
             "retries": rmodel.ingest_profile.total_retries,
             "max_abs_diff": float((retry_p - clean_p).abs().max())}
    check(retry["fired"] == 1 and retry["retries"] == 1,
          f"events b: retry {retry}")
    check(retry["max_abs_diff"] <= EV_PROBA_TOL,
          f"events b: the retried train's scores part by "
          f"{retry['max_abs_diff']} from the clean run's")

    # TM060: a reader with no cutoff is refused before any data moves
    lpred, _, _ = build_events(models_and_parameters=_lr_grid())
    leaky = (OpWorkflow().allow_non_serializable()
             .set_result_features(lpred)
             .set_reader(events_reader(clean, cutoff=False)))
    try:
        leaky.train()
        refused = None
    except PipelineLintError as exc:
        refused = sorted({d.rule for d in exc.findings.errors})
    check(refused == ["TM060"], f"events b: the leaky train gave {refused}")

    # drift: quiet on a fresh log, fired on 3x the event rate
    drift_names = ["n_events", "total_dwell", "n_checkout", "purchased"]
    drift_feats = [f for f in raw if f.name in drift_names]

    def observed(path):
        ds = events_reader(path).generate_dataset(drift_feats)
        cols = {f.name: ds[f.name].to_list() for f in drift_feats}
        return [dict(zip(cols, v)) for v in zip(*cols.values())]

    mon = DriftMonitor.from_model(rmodel, DriftConfig(
        min_rows=EV_DRIFT_ROWS, check_every=EV_DRIFT_ROWS))
    fresh = os.path.join(tmp, "b_fresh.jsonl")
    make_clickstream(fresh, EV_B_USERS, EV_HOLD_SEED)
    mon.observe_rows(observed(fresh))
    quiet = not mon.refresh_triggered
    fired, shifts = False, 0
    for k in range(3):
        shifted = os.path.join(tmp, f"b_shift{k}.jsonl")
        make_clickstream(shifted, EV_B_USERS, EV_HOLD_SEED + 1 + k,
                         rate=3.0)
        mon.observe_rows(observed(shifted))
        shifts += 1
        fired = mon.refresh_triggered
        if fired:
            break
    drift = {"quiet_on_fresh": quiet, "fired_on_3x_rate": fired,
             "shifted_logs": shifts, "drifted": list(
                 (mon.last_evaluation or {}).get("driftedFeatures", []))}
    check(quiet and fired, f"events b: drift {drift}")
    return {"users": EV_B_USERS, "events": n, "quarantine": quarantine,
            "retry": retry, "tm060_refused": refused, "drift": drift}


def phase_events(reps: int, bw: float, f32: float) -> dict:
    """Event-time AutoML on the card (the module docstring's phase 6f):
    leg a (the events DAG on EV_USERS users, in-core and streamed, each
    in a child; the kernel on the streamed model's checked matrix) and
    leg b (quarantine, retry, TM060, drift on EV_B_USERS users)."""
    phase_t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="tmog_events_")
    try:
        leg_a, kernel_row = _events_leg_a(tmp, reps, bw, f32)
        leg_b = _events_leg_b(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "events", "a": {k: leg_a[k] for k in (
        "keys_equal", "proba_max_abs_err", "rss_ratio")}, "b": leg_b,
          "phase_s": time.perf_counter() - phase_t0})
    emit(kernel_row)
    return {"seg_hist_launches": leg_a["in_core"]["seg_hist_launches"]
            + leg_a["streamed"]["seg_hist_launches"]}


# ---------------------------------------------------------------------------
# the app phase: the generated project of `python -m transmogrifai_tpu_torch
# gen` on a Titanic-shaped CSV
# ---------------------------------------------------------------------------

def _score_column(path: str) -> np.ndarray:
    """probability_1 of every row of a runner's scores CSV."""
    import ast

    with open(path, newline="") as fh:
        rows = csv.reader(fh)
        header = next(rows)
        j = next(i for i, h in enumerate(header) if h != "Survived")
        return np.array([ast.literal_eval(r[j])["probability_1"]
                         for r in rows])


def phase_app() -> dict:
    """The app entry points on the card (the module docstring's phase
    6g): APP_ROWS Titanic rows with an id written to CSV; ``gen`` in a
    child; the generated App in this process (train with the default
    selector, then evaluate, which writes its scores); the generated
    run.py's score in a child, whose scores must equal the evaluate
    run's; the metrics JSON's keys."""
    import importlib.util

    phase_t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="tmog_app_")
    try:
        cols, _ = titanic_columns(APP_ROWS)
        cols = {"PassengerId": np.arange(1, APP_ROWS + 1), **cols}
        data_csv = os.path.join(tmp, "titanic.csv")
        write_ooc_csv(data_csv, cols, 0, APP_ROWS)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        t0 = time.perf_counter()
        gen = subprocess.run(
            [sys.executable, "-m", "transmogrifai_tpu_torch", "gen",
             "Titanic", "--input", data_csv, "--id", "PassengerId",
             "--response", "Survived", "--dest", tmp],
            capture_output=True, text=True, env=env, timeout=600)
        gen_s = time.perf_counter() - t0
        check(gen.returncode == 0, f"app: gen failed: {gen.stderr[-2000:]}")
        root = os.path.join(tmp, "titanic")
        files = sorted(os.path.relpath(os.path.join(d, f), root)
                       for d, _, fs in os.walk(root) for f in fs
                       if not f.endswith(".pyc"))
        spec = importlib.util.spec_from_file_location(
            "titanic_run", os.path.join(root, "run.py"))
        run_mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(run_mod)
        app_mod = sys.modules["titanic.app"]
        model_dir = os.path.join(tmp, "model")
        eval_dir = os.path.join(tmp, "eval_scores")
        metrics_dir = os.path.join(tmp, "metrics")
        reader = run_mod.make_reader(data_csv)
        gk.seg_level_hists.launches = 0
        t0 = time.perf_counter()
        trained = app_mod.App(reader=reader).main(
            ["--run-type", "train", "--model-location", model_dir])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = gk.seg_level_hists.launches
        summ = next(v["model_selector_summary"]
                    for v in trained.summary.values()
                    if "model_selector_summary" in v)
        t0 = time.perf_counter()
        evaluated = app_mod.App(reader=reader).main(
            ["--run-type", "evaluate", "--model-location", model_dir,
             "--write-location", eval_dir,
             "--metrics-location", metrics_dir])
        eval_s = time.perf_counter() - t0
        score_dir = os.path.join(tmp, "child_scores")
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, os.path.join(root, "run.py"), "--run-type",
             "score", "--model-location", model_dir, "--write-location",
             score_dir], capture_output=True, text=True, env=env,
            timeout=900)
        child_s = time.perf_counter() - t0
        check(child.returncode == 0,
              f"app: run.py score failed: {child.stderr[-2000:]}")
        in_proc = _score_column(evaluated.scores_location)
        written = _score_column(os.path.join(score_dir, "scores.csv"))
        with open(os.path.join(metrics_dir, "op_metrics.json")) as fh:
            doc = json.load(fh)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    diff = (float(np.abs(in_proc - written).max())
            if len(in_proc) == len(written) else float("inf"))
    out = {"phase": "app", "rows": APP_ROWS, "gen_s": gen_s,
           "files": files, "winner": [summ["bestModelType"],
                                      summ["bestModelParams"]],
           "train_s": train_s, "seg_hist_launches": launches,
           "evaluate_s": eval_s, "evaluate_metrics": evaluated.metrics,
           "child_score_s": child_s, "scored_rows": len(written),
           "scores_max_abs_diff": diff, "scores_tol": APP_SCORE_TOL,
           "metrics_keys": sorted(doc), "app_keys": sorted(doc["app"]),
           "steps": sorted(m["step"] for m in doc["app"]["stepMetrics"]),
           "phase_s": time.perf_counter() - phase_t0}
    emit(out)
    check(files == sorted(["README.md", "__init__.py", "app.py",
                           "features.py", "run.py", "tests/test_app.py"]),
          f"app: gen wrote {files}")
    check(len(written) == APP_ROWS and diff <= APP_SCORE_TOL,
          f"app: run.py's {len(written)} scores part by {diff} from the "
          f"in-process ones")
    check(set(doc) == {"runType", "metrics", "app"} and set(doc["app"]) == {
        "appName", "runType", "appDurationSecs", "stepMetrics",
        "customTags"}, f"app: metrics JSON keys {out['metrics_keys']}, "
          f"{out['app_keys']}")
    check(launches > 0, "app: the train launched no seg_hist")
    check(np.isfinite(evaluated.metrics["AuPR"]),
          f"app: evaluate gave {evaluated.metrics}")
    return {"seg_hist_launches": launches}


# ---------------------------------------------------------------------------
# the multiclass phase: the default multiclass selector at 1M + 100k x 500
# ---------------------------------------------------------------------------

def _selector_pipeline(cols: int, selector):
    """The selector phase's DAG over ``cols`` Real columns with
    ``selector``: (prediction, checked vector)."""
    label = FeatureBuilder.RealNN("label").as_response()
    preds = [FeatureBuilder.Real(f"f{j}").as_predictor() for j in range(cols)]
    checked = label.transform_with(SanityChecker(max_correlation=0.99),
                                   transmogrify(preds))
    return label.transform_with(selector, checked), checked


def _train_counted(wf):
    """(model, seconds, seg_hist launches) of ``wf.train()``."""
    torch.cuda.synchronize()
    gk.seg_level_hists.launches = 0
    t0 = time.perf_counter()
    model = wf.train()
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0, gk.seg_level_hists.launches


def _forest_level_row(X: torch.Tensor, y: np.ndarray, msub: int, path: str,
                      reps: int, bw: float, f32: float) -> dict:
    """SO_CHECK_TREES forest trees (depth 12, min instances 10, min info
    gain 0.001, ``msub``-column subsets, the first of 3 stratified folds)
    grown on ``X`` binned at 32 bins, every level held bitwise to the
    plain version; the level of most slots timed: the kernel, the plain
    version, the library call and the bound."""
    dev = X.device
    _, binned = prep_tree_inputs(X, 32)
    fold = torch.from_numpy((make_folds(X.shape[0], 3, y=y, stratify=True,
                                        seed=42) != 0)
                            .astype(np.float32)).to(dev)
    chk = _BitwiseLevels()
    gk.grow_rf_grid(
        binned, torch.from_numpy(y).to(dev), fold[None], seed=42,
        n_trees=SO_CHECK_TREES, pair_fold=[0], pair_min_ig=[0.001],
        pair_min_inst=[10], pair_depth=[12], msub=msub, subsample_rate=1.0,
        n_bins=32, hist_fn=chk)
    b, slot, ch, M, B = chk.widest
    del binned, chk.widest
    n, dd = b.shape
    args = (b, slot, ch, M, B)
    nbytes = n * dd + n * 4 + n * 2 * 4 + M * 2 * B * dd * 4
    ops = n * dd * 2
    return {"phase": "seg_hist", "path": path, "N": n, "d": dd, "B": B,
            "nchan": 2, "M": M, "row_stride": b.stride(0),
            "trees": SO_CHECK_TREES, "levels_checked": chk.levels,
            "levels_unequal": chk.unequal, "max_abs_err": chk.max_err,
            "bitwise_equal": chk.unequal == 0,
            "kernel_ms": time_ms(lambda: gk.seg_level_hists(*args), reps),
            "plain_ms": time_ms(lambda: gk.seg_level_hists_plain(*args), 3,
                                1),
            "library_ms": _library_ms(b, slot, ch, M, B),
            "bound_ms": max(nbytes / bw, ops / f32) * 1e3,
            "bound_by": "bytes" if nbytes / bw >= ops / f32
            else "operations", "bytes": nbytes}


def _so_leg_a(data, cols: int, full_aupr: float, reps: int, bw: float,
              f32: float):
    """Leg a: the default selector under successive halving on the
    selector phase's 1M + 100k rows."""
    train, hold, _ = data
    selector = BinaryClassificationModelSelector.with_cross_validation(
        strategy="halving")
    pred, checked = _selector_pipeline(cols, selector)
    model, train_s, launches = _train_counted(
        OpWorkflow().set_result_features(pred).set_input_data(train))
    _, metrics = model.score_and_evaluate(
        Evaluators.BinaryClassification.auPR(), data=hold)
    aupr_h = float(metrics["AuPR"])
    meta = selector.metadata
    sched = meta["halving_schedule"]
    rungs = sched["rungs"]
    folds = selector.validator.num_folds
    summary = meta["model_selector_summary"]
    X = model.train_data[checked.name].values
    y = np.asarray(train["label"].values, np.float32)
    idx = np.sort(nested_subsample_order(y, HalvingConfig().seed)
                  [:rungs[0]["rows"]])
    Xs = X.index_select(0, torch.from_numpy(idx).to(X.device))
    msub = int(np.sqrt(X.shape[1]))
    level = _forest_level_row(Xs, y[idx], msub, "halving", reps, bw, f32)
    del X, Xs
    out = {"leg": "a", "rows": len(train), "train_s": train_s,
           "rungs": [{"rows": r["rows"], "candidates": r["survivorsIn"],
                      "promoted": r["promoted"], "wall_s": r["wallSecs"],
                      "candidate_fold_fits": r["survivorsIn"] * folds}
                     for r in rungs],
           "winner": summary["bestModelType"],
           "winner_params": summary["bestModelParams"],
           "holdout_aupr": aupr_h, "full_sweep_holdout_aupr": full_aupr,
           "seg_hist_launches": launches,
           "growers_hist_levels": meta["hist_levels"],
           "elastic": meta["elastic"]}
    check([(r["rows"], r["survivorsIn"]) for r in rungs] == SO_SCHEDULE,
          f"selector_options: halving schedule {rungs} != {SO_SCHEDULE}")
    check(abs(aupr_h - full_aupr) <= SO_AUPR_GAP,
          f"selector_options: halving AuPR {aupr_h} not within "
          f"{SO_AUPR_GAP} of the full sweep's {full_aupr}")
    check(launches > 0 and launches == meta["hist_levels"],
          f"selector_options: halving launches {launches} != the growers' "
          f"{meta['hist_levels']} levels")
    check(level["bitwise_equal"], "selector_options: the halving forest's "
                                  "levels are not bitwise equal to plain")
    return out, level


def sweep_child(ckpt: str, cols: int) -> None:
    """Leg b's child: the default selector with a sweep checkpoint at
    ``ckpt`` on SO_ROWS + SO_HOLDOUT rows (the process is killed at the
    ``sweep.checkpoint`` fault point its TMOG_FAULTS arms)."""
    train, _, _ = make_datasets(SO_ROWS, SO_HOLDOUT, cols)
    selector = BinaryClassificationModelSelector.with_cross_validation() \
        .with_sweep_checkpoint(ckpt)
    pred, _ = _selector_pipeline(cols, selector)
    OpWorkflow().set_result_features(pred).set_input_data(train).train()
    print(json.dumps({"child": "finished without the kill"}), flush=True)


def _so_fold_values(selector) -> list:
    return [r["foldValues"] for r in
            selector.metadata["model_selector_summary"]["validationResults"]]


def _so_leg_b(cols: int, tmp: str):
    """Leg b: a child killed at ``sweep.checkpoint``, the resume, the
    uninterrupted synchronous sweep, and a checkpoint of another grid."""
    from transmogrifai_tpu_torch.workflow.checkpoint import (
        SWEEP_CHECKPOINT_JSON, CheckpointMismatchError)

    data_b = make_datasets(SO_ROWS, SO_HOLDOUT, cols)
    ckpt = os.path.join(tmp, "sweep")
    env = dict(os.environ, TMOG_FAULTS=json.dumps({"faults": [{
        "point": "sweep.checkpoint", "action": "kill", "at": SO_KILL_AT}]}))
    env.pop("TMOG_SYNC_SWEEP", None)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--sweep-child", ckpt, "--cols", str(cols)],
                          env=env, capture_output=True, text=True,
                          timeout=900)
    child_s = time.perf_counter() - t0
    check(proc.returncode == -9, f"selector_options: the sweep child was "
                                 f"not killed (exit {proc.returncode}): "
                                 f"{proc.stderr[-2000:]}")
    with open(os.path.join(ckpt, SWEEP_CHECKPOINT_JSON)) as f:
        saved = len(json.load(f)["units"])
    other_dir = os.path.join(tmp, "other")
    os.makedirs(other_dir)
    shutil.copy(os.path.join(ckpt, SWEEP_CHECKPOINT_JSON), other_dir)
    other = BinaryClassificationModelSelector.with_cross_validation(
        models_and_parameters=[(OpLogisticRegression(),
                                grid(reg_param=[0.001, 0.01]))]) \
        .with_sweep_checkpoint(other_dir)
    mismatch = None
    try:
        other._sweep_checkpoint(other._candidates(), SO_ROWS)
    except CheckpointMismatchError as e:
        mismatch = str(e).split("differing keys:")[-1].strip().splitlines()

    resumed_sel = BinaryClassificationModelSelector.with_cross_validation() \
        .with_sweep_checkpoint(ckpt)
    pred, checked = _selector_pipeline(cols, resumed_sel)
    model, resume_s, resume_launches = _train_counted(
        OpWorkflow().set_result_features(pred).set_input_data(data_b[0]))
    restored = resumed_sel.metadata["sweep_checkpoint"]["restoredUnits"]
    X = model.train_data[checked.name].values
    y = np.asarray(data_b[0]["label"].values, np.float32)
    del model

    os.environ["TMOG_SYNC_SWEEP"] = "1"
    try:
        ref_sel = BinaryClassificationModelSelector.with_cross_validation()
        pred, _ = _selector_pipeline(cols, ref_sel)
        _, ref_s, ref_launches = _train_counted(
            OpWorkflow().set_result_features(pred).set_input_data(
                data_b[0]))
    finally:
        del os.environ["TMOG_SYNC_SWEEP"]
    a, b = _so_fold_values(resumed_sel), _so_fold_values(ref_sel)
    worst = max(abs(u - v) for fa, fb in zip(a, b) for u, v in zip(fa, fb))
    ra = resumed_sel.metadata["model_selector_summary"]
    rb = ref_sel.metadata["model_selector_summary"]
    out = {"leg": "b", "rows": SO_ROWS, "child_s": child_s,
           "kill_at_save": SO_KILL_AT, "units_saved_by_child": saved,
           "units_restored": restored,
           "units_refit": len(a) - restored, "resume_s": resume_s,
           "sync_reference_s": ref_s,
           "winner": ra["bestModelType"], "winner_params":
               ra["bestModelParams"],
           "reference_winner": rb["bestModelType"],
           "max_fold_metric_diff": worst, "bitwise_equal": a == b,
           "mismatch_diff": mismatch,
           "reference_sweep_seconds": ref_sel.metadata["sweep_seconds"]}
    check(saved == SO_KILL_AT + 1 and restored == saved,
          f"selector_options: {saved} units saved, {restored} restored")
    check((ra["bestModelType"], ra["bestModelParams"]) ==
          (rb["bestModelType"], rb["bestModelParams"]),
          "selector_options: the resumed sweep's winner differs from the "
          "uninterrupted sweep's")
    check(worst <= SO_METRIC_TOL, f"selector_options: resumed fold metrics "
                                  f"differ by {worst}")
    check(mismatch is not None and "candidates" in mismatch[0],
          f"selector_options: another grid's checkpoint did not raise a "
          f"mismatch naming the candidates: {mismatch}")
    return out, resume_launches + ref_launches, X, y


def _so_validate(sel, X, y, elastic=None):
    w = np.ones(len(y), np.float32)
    t0 = time.perf_counter()
    best, res = sel.validator.validate(
        sel._candidates(with_groups=False), X, y, w, eval_fn=sel._metric,
        metric_name=sel.validation_metric, larger_better=sel.larger_better,
        elastic=elastic)
    torch.cuda.synchronize()
    return best, res, time.perf_counter() - t0


def _so_leg_c(X: torch.Tensor, y: np.ndarray, sweep_seconds: dict):
    """Leg c: the device-loss ladder and the straggler watchdog on leg
    b's checked matrix, an LR grid and one forest, one fit a unit."""
    from transmogrifai_tpu_torch.tuning.costmodel import (CostModel,
                                                          StageObservation)
    from transmogrifai_tpu_torch.utils import faults

    def selector():
        return ModelSelector(
            [(OpLogisticRegression(), grid(reg_param=[0.001, 0.01, 0.1,
                                                      0.2])),
             (OpRandomForestClassifier(num_trees=SO_C_TREES),
              [{"max_depth": 6}])],
            problem_type="binary",
            validator=OpCrossValidation(num_folds=3, stratify=True))

    n, d = X.shape
    gk.seg_level_hists.launches = 0
    best0, ref, ref_s = _so_validate(selector(), X, y)
    runs = {}
    # the ladder runs under a trace: its flight events must link to the
    # sweep units they happened in
    tracer = obs.start_trace("selector_options.c", capture_hlo=False)
    try:
        for name, spec in (
                ("one_loss", faults.FaultSpec(point="device.loss",
                                              action="device_loss", at=1,
                                              times=1)),
                ("persistent_loss", faults.FaultSpec(
                    point="device.loss", action="device_loss", at=4,
                    times=None))):
            sel = selector()
            ctx = sel._elastic_context(n, d, 5, "cuda")
            with faults.inject(spec):
                best, res, secs = _so_validate(sel, X, y, ctx)
            runs[name] = (best, res, ctx.counters.to_json(), secs)
    finally:
        obs.stop_trace()
    ladder = _ladder_trace(tracer)
    # the watchdog: a cost model fitted on leg b's group walls on this card
    cm = CostModel().fit([
        StageObservation("ModelSelector:fit", n, d, "float32", "cuda",
                         sweep_seconds["LogRegGridGroup"]),
        StageObservation("RandomForest:fit-grid", n, d, "float32", "cuda",
                         sweep_seconds["RFGridGroup"])])
    sel = selector().with_watchdog(SO_WATCHDOG_FACTOR, cost_model=cm)
    ctx = sel._elastic_context(n, d, 5, "cuda")
    deadline = ctx.unit_deadline_s
    with faults.inject(faults.FaultSpec(
            point="unit.slow", action="slow", at=1, times=2,
            delay_s=SO_SLOW_FACTOR * deadline)):
        best, res, secs = _so_validate(sel, X, y, ctx)
    runs["watchdog"] = (best, res, ctx.counters.to_json(), secs)
    launches = gk.seg_level_hists.launches

    # the prefetch thread joined after a loss, through fit_columns
    sel = selector()
    drains = []
    drain = sel._drain_tree_prefetch

    def recording_drain(*a, **k):
        t = sel._prep_thread
        drain(*a, **k)
        drains.append(t is None or not t.is_alive())

    sel._drain_tree_prefetch = recording_drain
    gk.seg_level_hists.launches = 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with faults.inject(faults.FaultSpec(point="device.loss",
                                            action="device_loss", at=0,
                                            times=1)):
            sel.fit_columns(None, FeatureColumn.from_values(
                ft.RealNN, y.astype(np.float64)),
                FeatureColumn(ft.OPVector, X))
    launches += gk.seg_level_hists.launches

    def diff(res):
        return max((abs(u - v) for a, b in zip(res, ref) if a.error is None
                    for u, v in zip(a.fold_values, b.fold_values)),
                   default=0.0)

    out = {"leg": "c", "units": 5, "reference_s": ref_s,
           "ladder_trace": ladder, "watchdog_deadline_s": deadline,
           "slow_delay_s": SO_SLOW_FACTOR * deadline,
           "prefetch": sel.metadata.get("tree_prefetch"),
           "prefetch_drains_joined": drains,
           "prefetch_elastic": sel.metadata["elastic"]}
    for name, (best, res, counters, secs) in runs.items():
        out[name] = {"seconds": secs, "counters": counters,
                     "errors": [r.error for r in res],
                     "winner_index": best, "max_fold_metric_diff": diff(res)}
    one, per, wd = runs["one_loss"], runs["persistent_loss"], runs["watchdog"]
    check(one[2]["retries"] == 1 and one[2]["quarantined"] == 0
          and all(r.error is None for r in one[1]) and one[0] == best0
          and diff(one[1]) <= SO_METRIC_TOL,
          f"selector_options: one device loss {out['one_loss']}")
    check(ladder["chain_in_order"] and ladder["elastic_events"] > 0
          and ladder["elastic_off_units"] == 0,
          f"selector_options: the traced ladder {ladder}")
    check(per[2]["quarantined"] == 1 and per[1][4].error.startswith(
        "failed: device_loss") and sum(r.error is not None
                                       for r in per[1]) == 1,
          f"selector_options: persistent loss {out['persistent_loss']}")
    check(wd[2]["watchdogFires"] == 2 and wd[2]["retries"] == 1
          and wd[2]["quarantined"] == 1 and wd[1][1].error.startswith(
              "failed: straggler")
          and sum(r.error is not None for r in wd[1]) == 1,
          f"selector_options: watchdog {out['watchdog']}")
    check(sel.metadata["elastic"]["deviceLosses"] == 1 and drains
          and all(drains) and sel._prep_thread is None
          and (sel.metadata.get("tree_prefetch") or {}).get("joined"),
          f"selector_options: the prefetch thread after a loss: {drains}, "
          f"{sel.metadata.get('tree_prefetch')}")
    return out, launches


def _ladder_trace(tracer) -> dict:
    """The traced ladder's flight record: the kinds in causal order, the
    fault -> loss -> retry chain, each elastic event's span."""
    kinds = tracer.flight.kinds()
    units = {sp.span_id: sp.name for sp in tracer.snapshot()
             if sp.name.startswith("sweep.unit[")}
    elastic = tracer.flight.events("elastic.")
    it = iter(kinds)
    chain = all(any(k == h for h in it) for k in (
        "fault.fired", "elastic.device_losses", "elastic.retries"))
    return {"kinds": kinds[:12], "events": len(kinds),
            "elastic_events": len(elastic),
            "elastic_spans": sorted({units.get(e["spanId"], "?")
                                     for e in elastic}),
            "elastic_off_units": sum(e["spanId"] not in units
                                     for e in elastic),
            "chain_in_order": chain}


def _so_leg_d():
    """Leg d: the Titanic demo with the default selector under workflow
    CV on SO_ROWS + SO_HOLDOUT rows, and a plain train of it."""
    from transmogrifai_tpu_torch.workflow.dag import cut_dag_cv

    train, hold, p_hold, _ = titanic_data(SO_ROWS, SO_HOLDOUT)
    out = {"leg": "d", "rows": SO_ROWS}
    launches = 0
    for mode in ("workflow_cv", "plain"):
        pred, _, _, selector = build_titanic(
            selector=BinaryClassificationModelSelector.with_cross_validation())
        wf = OpWorkflow().set_result_features(pred).set_input_data(train)
        if mode == "workflow_cv":
            cut = cut_dag_cv(compute_dag([pred]))
            during = sorted({type(s).__name__
                             for s in cut.during.all_stages()})
            wf = wf.with_workflow_cv()
        model, train_s, n = _train_counted(wf)
        launches += n
        _, metrics = model.score_and_evaluate(
            Evaluators.BinaryClassification.auPR(), data=hold)
        summ = selector.metadata["model_selector_summary"]
        out[mode] = {"train_s": train_s, "seg_hist_launches": n,
                     "holdout_aupr": float(metrics["AuPR"]),
                     "winner": summ["bestModelType"],
                     "winner_params": summ["bestModelParams"],
                     "growers_hist_levels": selector.metadata["hist_levels"]}
        if mode == "workflow_cv":
            out["during_stages"] = during
            out["workflow_cv_results"] = len(
                selector.metadata["workflow_cv_results"])
    gap = abs(out["workflow_cv"]["holdout_aupr"]
              - out["plain"]["holdout_aupr"])
    out["aupr_gap"] = gap
    check("SanityChecker" in out["during_stages"],
          f"selector_options: SanityChecker not in the during-DAG "
          f"{out['during_stages']}")
    check(out["workflow_cv_results"] == 26,
          f"selector_options: {out['workflow_cv_results']} workflow CV "
          f"results, not 26")
    check(gap <= SO_CV_AUPR_GAP, f"selector_options: workflow CV AuPR "
                                 f"differs from the plain train's by {gap}")
    return out, launches


def phase_selector_options(data, full_aupr: float, cols: int, reps: int,
                           bw: float, f32: float) -> Tuple[dict, dict]:
    """The selector options on the card (the module docstring's phase 4b):
    legs a (halving at full size), b (checkpoint, kill, resume), c (the
    elastic ladder and the watchdog) and d (workflow CV), each printed as
    a ``selector_options`` line, then the ``seg_hist`` line of the halving
    rung-0 forest's widest level.  Returns the phase's summary and that
    line."""
    phase_t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="tmog_sweep_")
    try:
        t0 = time.perf_counter()
        a, level = _so_leg_a(data, cols, full_aupr, reps, bw, f32)
        a["leg_s"] = time.perf_counter() - t0
        emit(dict(phase="selector_options", **a))
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        b, b_launches, X, y = _so_leg_b(cols, tmp)
        b["leg_s"] = time.perf_counter() - t0
        emit(dict(phase="selector_options", **b))
        t0 = time.perf_counter()
        c, c_launches = _so_leg_c(X, y, b["reference_sweep_seconds"])
        c["leg_s"] = time.perf_counter() - t0
        emit(dict(phase="selector_options", **c))
        del X
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        d, d_launches = _so_leg_d()
        d["leg_s"] = time.perf_counter() - t0
        emit(dict(phase="selector_options", **d))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit(level)
    out = {"phase": "selector_options_summary",
           "seconds": time.perf_counter() - phase_t0,
           "seg_hist_launches": (a["seg_hist_launches"] + b_launches
                                 + c_launches + d_launches),
           "launches_by_leg": {"a": a["seg_hist_launches"], "b": b_launches,
                               "c": c_launches, "d": d_launches}}
    emit(out)
    return out, level


def _softmax_np(z: np.ndarray) -> np.ndarray:
    e = np.exp(z - z.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


def make_multiclass_data(data):
    """The multiclass phase's datasets over the slice's 500 Real columns
    (the same host arrays): a K = MC_CLASSES label from MC_SEED.  Class
    k's logit is log(MC_PRIORS[k]) plus a linear part of standard
    deviation MC_LINEAR_SD in its own group of MC_GROUP_COLS columns
    (gk .. gk + g - 1), class 0 adds tanh(f0 f5); the label
    is the argmax of the logits plus Gumbel noise, so the true class
    probabilities are the logits' softmax.  Returns (train, holdout, the
    attainable holdout F1 — the argmax of the true probabilities —, the
    class shares, seconds)."""
    train, hold, _ = data
    t0 = time.perf_counter()
    rows, holdout = len(train), len(hold)
    n = rows + holdout
    K = MC_CLASSES
    rng = np.random.default_rng(MC_SEED)
    g = MC_GROUP_COLS
    F = np.stack([np.concatenate([train[f"f{j}"].values,
                                  hold[f"f{j}"].values])
                  for j in range(g * K)], axis=1)
    beta = rng.normal(size=(K, g))
    beta *= MC_LINEAR_SD / np.linalg.norm(beta, axis=1, keepdims=True)
    logits = np.log(np.asarray(MC_PRIORS))[None, :] + np.stack(
        [F[:, g * k:g * k + g] @ beta[k] for k in range(K)], axis=1)
    logits[:, 0] += np.tanh(F[:, 0] * F[:, 5])
    y = (logits + rng.gumbel(size=(n, K))).argmax(1).astype(np.float64)
    bayes = logits[rows:].argmax(1)
    attainable = multiclass_metrics(torch.from_numpy(y[rows:]),
                                    torch.from_numpy(bayes), K)["F1"]
    shares = np.bincount(y[:rows].astype(int), minlength=K) / rows

    def dataset(base, sl):
        cols = {k: c for k, c in base.columns.items() if k != "label"}
        cols["label"] = FeatureColumn.from_values(ft.RealNN, y[sl])
        return ColumnarDataset(cols)

    return (dataset(train, slice(0, rows)), dataset(hold, slice(rows, n)),
            float(attainable), shares.tolist(), time.perf_counter() - t0)


def _class_levels(X: torch.Tensor, y: np.ndarray, msub: int, reps: int,
                  bw: float, f32: float) -> dict:
    """MC_CHECK_TREES K-class forest trees (the default grid's loosest
    gates: depth 12, min instances 10, min info gain 0.001; ``msub``-column
    subsets; the first fold's weights) grown on the checked matrix, every
    level held bitwise to the plain version at K channels; then the level
    of most slots timed: the kernel, the plain version, the library call
    (one weighted ``torch.bincount`` a channel) and the bound."""
    dev = X.device
    edges, binned = prep_tree_inputs(X, 32)
    fold = torch.from_numpy(
        (make_folds(X.shape[0], 3, y=y, stratify=True, seed=42) != 0
         ).astype(np.float32)).to(dev)
    chk = _BitwiseLevels()
    forest = gk.grow_rf_grid(
        binned, torch.from_numpy(y.astype(np.float32)).to(dev), fold[None],
        seed=42, n_trees=MC_CHECK_TREES, pair_fold=[0], pair_min_ig=[0.001],
        pair_min_inst=[10], pair_depth=[12], msub=msub, subsample_rate=1.0,
        n_bins=32, hist_fn=chk, n_classes=MC_CLASSES)
    b, slot, ch, M, B = chk.widest
    del binned, chk.widest
    n, dd = b.shape
    C = ch.shape[1]
    args = (b, slot, ch, M, B)
    kernel_ms = time_ms(lambda: gk.seg_level_hists(*args), reps)
    plain_ms = time_ms(lambda: gk.seg_level_hists_plain(*args), 3, 1)
    library_ms = _library_ms(b, slot, ch, M, B)
    nbytes = n * dd + n * 4 + n * C * 4 + M * C * B * dd * 4
    ops = n * dd * C
    return {"phase": "seg_hist", "path": "multiclass", "N": n, "d": dd,
            "B": B, "nchan": C, "M": M, "row_stride": b.stride(0),
            "trees": MC_CHECK_TREES, "levels_checked": chk.levels,
            "levels_unequal": chk.unequal, "max_abs_err": chk.max_err,
            "bitwise_equal": chk.unequal == 0,
            "splits": int((forest.thresh < 32).sum()),
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "bound_ms": max(nbytes / bw, ops / f32) * 1e3,
            "bound_by": "bytes" if nbytes / bw >= ops / f32
            else "operations", "bytes": nbytes}


def _library_ms(b, slot, ch, M: int, B: int) -> float:
    """The library yardstick of one level: one weighted ``torch.bincount``
    a channel over the flat (slot, bin, column) index."""
    n, dd = b.shape
    flat = ((slot.long()[:, None] * B + b.long()) * dd
            + torch.arange(dd, device=b.device)[None, :]).reshape(-1)
    ws = [ch[:, c:c + 1].expand(n, dd).reshape(-1)
          for c in range(ch.shape[1])]
    ms = time_ms(lambda: [torch.bincount(flat, weights=w,
                                         minlength=M * B * dd)
                          for w in ws], 3, 1)
    del flat, ws
    return ms


def _serve_multiclass(model, pred, hold, names, proba, tmp: str,
                      name: str) -> dict:
    """Save -> load on the card -> the holdout bitwise; the local scorer's
    64 rows within 1e-6; MC_SERVE_REQUESTS single rows through
    ModelServer (p50/p99), served probabilities within 1e-6."""
    path = os.path.join(tmp, name)
    K = proba.shape[1]
    req = _regression_rows(hold, names, MC_SERVE_REQUESTS)
    t0 = time.perf_counter()
    model.save(path)
    save_s = time.perf_counter() - t0
    nbytes = _dir_bytes(path)
    t0 = time.perf_counter()
    loaded = OpWorkflowModel.load(path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    reloaded = loaded.score(hold)[pred.name].values.probability
    bitwise = bool(torch.equal(reloaded, proba))
    want = proba[:MC_SERVE_REQUESTS].cpu().numpy().astype(np.float64)
    local = np.asarray([[r[pred.name][f"probability_{k}"] for k in range(K)]
                        for r in score_function_batch(loaded)(req[:64])])
    local_diff = float(np.abs(local - want[:64]).max())
    lat, served = [], []
    with ModelServer.from_path(path, name=name, max_batch=64,
                               warmup_row=req[0]) as srv:
        for r in req:
            t = time.perf_counter()
            out = srv.score([r])
            lat.append(time.perf_counter() - t)
            served.append([out[0][pred.name][f"probability_{k}"]
                           for k in range(K)])
        snap = srv.snapshot()
    served_diff = float(np.abs(np.asarray(served) - want).max())
    return {"save_s": save_s, "load_s": load_s, "artifact_bytes": nbytes,
            "holdout_bitwise_after_load": bitwise,
            "local_scorer_max_abs_diff": local_diff,
            "serve_batch1": _pcts(lat), "served_max_abs_diff": served_diff,
            "server_shed": snap["shed"],
            "server_device_errors": snap["deviceErrors"]}


def phase_multiclass(data, cols: int, reps: int, bw: float,
                     f32: float) -> dict:
    """The default multiclass selector (softmax LR 4 x 2 and K-class
    forests 3 x 2 x 3 at 50 trees, 3 stratified folds, F1, DataCutter) on
    the slice's columns with a K = 5 label; the kernel on the forests'
    own levels; save/load, the local scorer and single-row serving."""
    train, hold, attainable, shares, data_s = make_multiclass_data(data)
    rows, holdout = len(train), len(hold)
    K = MC_CLASSES
    label = FeatureBuilder.RealNN("label").as_response()
    names = [f"f{j}" for j in range(cols)]
    preds = [FeatureBuilder.Real(nm).as_predictor() for nm in names]
    checked = label.transform_with(SanityChecker(max_correlation=0.99),
                                   transmogrify(preds))
    selector = MultiClassificationModelSelector.with_cross_validation()
    pred = label.transform_with(selector, checked)
    wf = OpWorkflow().set_result_features(pred).set_input_data(train)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gk.seg_level_hists.launches = 0
    t0 = time.perf_counter()
    model = wf.train()
    train_s = time.perf_counter() - t0
    launches = gk.seg_level_hists.launches
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    scored, metrics = model.score_and_evaluate(
        Evaluators.MultiClassification.f1(), data=hold)
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    proba = scored[pred.name].values.probability
    f1 = float(metrics["F1"])

    meta = selector.metadata
    summary = meta["model_selector_summary"]
    results = summary["validationResults"]
    X = model.train_data[checked.name].values
    msub = int(np.sqrt(X.shape[1]))
    y = np.asarray(train["label"].values, np.float64)
    kernel_row = _class_levels(X, y, msub, reps, bw, f32)
    del X
    tmp = os.path.join(REPO, "smoke_out")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        served = _serve_multiclass(model, pred, hold, names, proba, tmp,
                                   "multiclass")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    out = {"phase": "multiclass", "rows": rows, "holdout": holdout,
           "cols": cols, "classes": K, "class_shares": shares,
           "folds": selector.validator.num_folds, "data_s": data_s,
           "train_s": train_s, "score_s": score_s,
           "stage_seconds": model.stage_seconds,
           "sweep_seconds": meta["sweep_seconds"],
           "group_errors": meta["group_errors"],
           "tree_phase_seconds": meta["tree_phase_seconds"],
           "refit_seconds": meta["refit_seconds"],
           "metrics_seconds": meta["metrics_seconds"],
           "sequential_fits": meta["sequential_fits"],
           "splitter": summary["dataPrepResults"],
           "winner": summary["bestModelType"],
           "winner_params": summary["bestModelParams"],
           "cv": [{"model": r["modelType"], "params": r["params"],
                   "f1": r["metricValue"], "error": r.get("error")}
                  for r in results],
           "train_metrics": summary["trainEvaluationMetrics"],
           "holdout_f1": f1, "holdout_accuracy": metrics["Accuracy"],
           "holdout_logloss": metrics["LogLoss"],
           "attainable_f1": attainable,
           "f1_floor": MC_F1_SHARE * attainable,
           "trees_grown": meta["rf_trees"],
           "group_trees": meta["group_trees"],
           "seg_hist_launches": launches,
           "growers_hist_levels": meta["hist_levels"],
           "max_memory_allocated": peak,
           "dropped_columns": len(checked.origin_stage.metadata["summary"]
                                  ["dropped"]), **served}
    emit(out)
    emit(kernel_row)
    check(tuple(proba.shape) == (holdout, K), f"proba shape {proba.shape}")
    check(bool(torch.isfinite(proba).all()), "non-finite probabilities")
    check(len(results) == 26, f"{len(results)} validation results, not 26")
    errors = [r["error"] for r in results if r.get("error")]
    check(not errors, f"candidates failed: {errors}")
    check(not meta["group_errors"],
          f"grid groups failed: {meta['group_errors']}")
    check({"SoftmaxGridGroup", "RFGridGroup"} <= set(meta["sweep_seconds"]),
          f"grid groups not run: {sorted(meta['sweep_seconds'])}")
    check(launches > 0 and launches == meta["hist_levels"],
          f"seg_hist launches {launches} != the growers' "
          f"{meta['hist_levels']} histogram levels")
    check(kernel_row["bitwise_equal"] and kernel_row["levels_checked"] > 0
          and kernel_row["nchan"] == K,
          f"multiclass: {kernel_row['levels_unequal']} of "
          f"{kernel_row['levels_checked']} levels at "
          f"{kernel_row['nchan']} channels differ from the plain version "
          f"by up to {kernel_row['max_abs_err']}")
    check(f1 >= MC_F1_SHARE * attainable,
          f"multiclass: holdout F1 {f1} below {MC_F1_SHARE} x the "
          f"attainable {attainable}")
    check(served["holdout_bitwise_after_load"],
          "multiclass: holdout scores after save/load differ")
    check(served["local_scorer_max_abs_diff"] <= 1e-6,
          f"multiclass: local scorer rows "
          f"{served['local_scorer_max_abs_diff']} from the batch")
    check(served["served_max_abs_diff"] <= 1e-6 and served["server_shed"] == 0
          and served["server_device_errors"] == 0,
          f"multiclass: served scores {served['served_max_abs_diff']} from "
          f"the in-memory model's, shed {served['server_shed']}, device "
          f"errors {served['server_device_errors']}")
    return out, (train, hold, attainable)


# ---------------------------------------------------------------------------
# the boosted_multi phase: the general grower (softmax boosting, decision
# trees, count-gated and subsampled boosting) at 500k + 50k rows
# ---------------------------------------------------------------------------

def _softmax_check(X: torch.Tensor, y: np.ndarray, est, fold) -> dict:
    """BOOSTED_CHECK_ROUNDS rounds of ``est``'s softmax fit (K =
    MC_CLASSES, 2K+1 = 11 float channels with the count) grown on the
    checked matrix on ``fold``'s weights, every level held against the
    plain version (``_LevelCheck``)."""
    dev = X.device
    edges, binned = prep_tree_inputs(X, 32)
    chk = _LevelCheck()
    grown = boost_chains(
        [est], binned, edges, torch.from_numpy(y.astype(np.float32)).to(dev),
        fold[None], torch.zeros((1, MC_CLASSES)), [], hist_fn=chk)
    return {**chk.summary(), "rounds": len(grown.trees[0]),
            "splits": sum(int((t.thresh < 32).sum()) for t in grown.trees[0])}


def _tree_levels(X: torch.Tensor, y: np.ndarray, fold, depth: int,
                 min_instances: float) -> Tuple[dict, "_BitwiseLevels"]:
    """One K-class decision tree (the selector's deepest candidate) grown
    on the checked matrix on ``fold``'s weights, binned through the dense
    sketch as ``OpDecisionTreeClassifier`` bins: its 2K+1 = 11 channels
    (w [y=k], w in each hessian column, w) are integers, so every level
    must equal the plain version bitwise (``_BitwiseLevels``)."""
    dev = X.device
    binned = gk.apply_bins(X, gk.quantile_bins(X, 32))
    Y = torch.nn.functional.one_hot(
        torch.from_numpy(y.astype(np.int64)).to(dev), MC_CLASSES).float()
    chk = _BitwiseLevels()
    tree = gk.grow_tree(binned, Y * fold[:, None],
                        fold[:, None].repeat(1, MC_CLASSES), depth, 32,
                        C=fold, lam=gk.RF_LAMBDA, min_info_gain=0.0,
                        min_instances=min_instances, newton_leaf=False,
                        hist_fn=chk)
    del binned
    return ({"levels": chk.levels, "levels_unequal": chk.unequal,
             "max_abs_err": chk.max_err, "bitwise_equal": chk.unequal == 0,
             "splits": int((tree.thresh < 32).sum())}, chk)


def _binary_checks(X: torch.Tensor, yb: np.ndarray) -> dict:
    """BOOSTED_CHECK_ROUNDS rounds of the count-gated GBT and of the
    subsampled XGBoost fit of ``count_and_subsample`` (3 float channels:
    gradient, hessian, count) on the slice's binary label, every level
    held against the plain version (``_LevelCheck``)."""
    dev = X.device
    n = X.shape[0]
    edges, binned = prep_tree_inputs(X, 32)
    yt = torch.from_numpy(yb).to(dev)
    w = torch.ones((1, n), device=dev)
    p0 = float(np.clip(yb.mean(), 1e-6, 1 - 1e-6))
    base = torch.tensor([float(np.log(p0 / (1 - p0)))])
    out = {}
    for name, est in _binary_estimators(BOOSTED_CHECK_ROUNDS).items():
        chk = _LevelCheck()
        grown = boost_chains([est], binned, edges, yt, w, base, [],
                             hist_fn=chk,
                             rng=np.random.default_rng(est.seed))
        out[name] = {**chk.summary(), "rounds": len(grown.trees[0]),
                     "splits": sum(int((t.thresh < 32).sum())
                                   for t in grown.trees[0])}
    return out


def _binary_estimators(rounds: int) -> dict:
    """``count_and_subsample``'s two fits: Spark-GBT gates (min instances
    and min info gain: the count channel) and XGBoost row and column
    subsampling (the per-round loop, with the count channel)."""
    return {
        "count_gated_gbt": OpGBTClassifier(
            max_depth=6, max_iter=rounds, min_instances_per_node=10,
            min_info_gain=0.001),
        "subsampled_xgb": OpXGBoostClassifier(
            max_depth=6, num_round=rounds, subsample=0.8,
            colsample_bytree=0.5, early_stopping_rounds=0)}


def _level_row(path: str, args, reps: int, bw: float, f32: float,
               smem_bw: float, integer: bool) -> dict:
    """One ``seg_hist`` line at a level of ``path``: the kernel against the
    plain version (bitwise for integer channels, else the tolerance of
    |channels|), kernel, plain and library ms, the bytes bound and the
    shared-memory floor (8C bytes of shared memory a (row, column))."""
    b, slot, ch, M, B = args
    n, dd = b.shape
    C = ch.shape[1]
    k = gk.seg_level_hists(*args)
    p = gk.seg_level_hists_plain(*args)
    mag = gk.seg_level_hists_plain(b, slot, ch.abs(), M, B)
    diff = (k - p).abs()
    kernel_ms = time_ms(lambda: gk.seg_level_hists(*args), reps)
    plain_ms = time_ms(lambda: gk.seg_level_hists_plain(*args), 3, 1)
    library_ms = _library_ms(b, slot, ch, M, B)
    nbytes = n * dd + n * 4 + n * C * 4 + M * C * B * dd * 4
    ops = n * dd * C
    row = {"phase": "seg_hist", "path": path, "N": n, "d": dd, "B": B,
           "nchan": C, "M": M, "row_stride": b.stride(0),
           "integer_channels": integer,
           "channel_groups": [list(g) for g in gk.seg_channel_groups(C, B)],
           "max_abs_err": float(diff.max()),
           "tol_ratio": float((diff / (ATOL + RTOL * mag)).max()),
           "bitwise_equal": bool(torch.equal(k, p)),
           "kernel_ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": library_ms,
           "bound_ms": max(nbytes / bw, ops / f32) * 1e3,
           "bound_by": "bytes" if nbytes / bw >= ops / f32 else "operations",
           "smem_floor_ms": 8 * C * n * dd / smem_bw * 1e3, "bytes": nbytes}
    emit(row)
    what = f"seg_hist {path} C={C} M={M} d={dd}"
    check(row["tol_ratio"] <= 1.0, f"{what}: kernel vs plain error "
          f"{row['max_abs_err']} beyond the tolerance")
    check(not integer or row["bitwise_equal"], f"{what}: integer channels, "
          f"yet the kernel differs from the plain version by "
          f"{row['max_abs_err']}")
    return row


def _general_level_rows(X: torch.Tensor, K: int, path: str, slots,
                        reps: int, bw: float, f32: float,
                        smem_bw: float) -> None:
    """``seg_hist`` lines at the general grower's level shape on the
    checked matrix's bins (d columns, 2K+1 float channels: K gradients in
    [-1, 1], K hessians in [0, 0.25] and a 0/1 count) at random slots:
    ``gbdt_multi`` (K = MC_CLASSES, M = 1, 32 and 512: depth 10's last
    level) and ``gbdt_count`` (K = 1, the count-gated and subsampled
    binary fits at depth 6: M = 1 and 32)."""
    dev = X.device
    gen = torch.Generator(device=dev).manual_seed(3)
    _, binned = prep_tree_inputs(X, 32)
    n = binned.shape[0]
    ch = torch.cat([torch.rand((n, K), device=dev, generator=gen) * 2 - 1,
                    torch.rand((n, K), device=dev, generator=gen) * 0.25,
                    (torch.rand((n, 1), device=dev, generator=gen) < 2 / 3)
                    .float()], 1).contiguous()
    for M in slots:
        slot = torch.randint(0, M, (n,), dtype=torch.int32, device=dev,
                             generator=gen)
        _level_row(path, (binned, slot, ch, M, 32), reps, bw, f32, smem_bw,
                   integer=False)
        del slot
    del binned, ch


def _timed_fit(est, X, y) -> Tuple[object, float]:
    """``est.fit_raw`` on the card; its model and the seconds it took."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = est.fit_raw(X, y, device=X.device)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def phase_boosted_multi(mc, data, cols: int, reps: int, bw: float,
                        f32: float, smem_bw: float) -> dict:
    """The general grower on the multiclass phase's datasets: the
    multiclass selector over a softmax XGBoost grid and a decision-tree
    grid (3 stratified folds, F1; every candidate a sequential fit), with
    save/load, the local scorer and single-row serving of its winner;
    ``xgb_defaults`` (one softmax fit at the reference's XGBoost
    defaults); ``count_and_subsample`` (count-gated GBT and subsampled
    XGBoost on the slice's binary label); the levels of every new path
    held against the plain version; ``seg_hist`` lines at the new channel
    counts."""
    train, hold, attainable = mc
    btrain, bhold, _ = data
    rows, holdout = len(train), len(hold)
    K = MC_CLASSES
    label = FeatureBuilder.RealNN("label").as_response()
    names = [f"f{j}" for j in range(cols)]
    preds = [FeatureBuilder.Real(nm).as_predictor() for nm in names]
    checked = label.transform_with(SanityChecker(max_correlation=0.99),
                                   transmogrify(preds))
    selector = MultiClassificationModelSelector.with_cross_validation(
        models_and_parameters=[
            (OpXGBoostClassifier(num_round=BOOSTED_SELECTOR_ROUNDS, eta=0.3,
                                 early_stopping_rounds=0),
             grid(max_depth=[4, 6])),
            (OpDecisionTreeClassifier(),
             grid(max_depth=[6, 10], min_instances_per_node=[10]))])
    pred = label.transform_with(selector, checked)
    wf = OpWorkflow().set_result_features(pred).set_input_data(train)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gk.seg_level_hists.launches = 0
    t0 = time.perf_counter()
    model = wf.train()
    train_s = time.perf_counter() - t0
    launches = gk.seg_level_hists.launches
    peak = torch.cuda.max_memory_allocated()
    scored, metrics = model.score_and_evaluate(
        Evaluators.MultiClassification.f1(), data=hold)
    torch.cuda.synchronize()
    proba = scored[pred.name].values.probability
    f1 = float(metrics["F1"])
    meta = selector.metadata
    summary = meta["model_selector_summary"]
    results = summary["validationResults"]
    tmp = os.path.join(REPO, "smoke_out")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        served = _serve_multiclass(model, pred, hold, names, proba, tmp,
                                   "boosted_multi")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # the checked matrices: the selector's fitted vectorizers and checker
    X = model.train_data[checked.name].values
    Xh = _checked_matrix(model, checked, hold)
    y = np.asarray(train["label"].values, np.float64)
    yh = torch.from_numpy(np.asarray(hold["label"].values, np.int64)).to(
        X.device)
    stage_seconds = model.stage_seconds
    del model, scored

    # xgb_defaults: the reference's XGBoost defaults, K classes
    est = OpXGBoostClassifier(num_class=K)
    gk.seg_level_hists.launches = 0
    xgb, xgb_s = _timed_fit(est, X, y)
    xgb_launches = gk.seg_level_hists.launches
    batch = xgb.predict_batch(Xh)
    p = torch.clamp(batch.probability.to(torch.float64), 1e-15, 1.0)
    xgb_out = {
        "num_round": est.num_round, "max_depth": est.max_depth,
        "eta": est.eta, "gamma": est.gamma,
        "early_stopping_rounds": est.early_stopping_rounds,
        "fit_s": xgb_s, **est.metadata["fit_timing"],
        "rounds_grown": est.metadata["rounds_grown"],
        "rounds_kept": est.metadata["best_len"],
        "ms_per_round": est.metadata["fit_timing"]["boosting_s"]
        / est.metadata["rounds_grown"] * 1e3,
        "holdout_f1": multiclass_metrics(yh, batch.prediction.long(),
                                         K)["F1"],
        "holdout_logloss": float(-torch.log(
            p[torch.arange(len(yh), device=p.device), yh]).mean()),
        "seg_hist_launches": xgb_launches,
        "growers_hist_levels": est.metadata["hist_levels"],
        "mode": xgb.mode}
    del xgb, batch, p

    # count_and_subsample: the slice's binary label on the same matrix
    yb = np.asarray(btrain["label"].values, np.float32)
    ybh = torch.from_numpy(np.asarray(bhold["label"].values, np.float32))
    cs_out = {}
    for name, est in _binary_estimators(BOOSTED_BINARY_ROUNDS).items():
        gk.seg_level_hists.launches = 0
        m, fit_s = _timed_fit(est, X, yb)
        got = gk.seg_level_hists.launches
        score = m.predict_batch(Xh).probability[:, 1]
        cs_out[name] = {
            "fit_s": fit_s, **est.metadata["fit_timing"],
            "rounds_grown": est.metadata["rounds_grown"],
            "ms_per_round": est.metadata["fit_timing"]["boosting_s"]
            / est.metadata["rounds_grown"] * 1e3,
            "holdout_aupr": aupr(ybh.to(score.device), score),
            "seg_hist_launches": got,
            "growers_hist_levels": est.metadata["hist_levels"]}
        del m, score

    # every level of the new paths against the plain version
    fold = torch.from_numpy(
        (make_folds(X.shape[0], 3, y=y, stratify=True, seed=42) != 0
         ).astype(np.float32)).to(X.device)
    checks = {"softmax": _softmax_check(
        X, y, OpXGBoostClassifier(max_depth=6, num_round=BOOSTED_CHECK_ROUNDS,
                                  eta=0.3, early_stopping_rounds=0), fold)}
    checks["decision_tree"], dt_chk = _tree_levels(X, y, fold, 10, 10.0)
    checks.update(_binary_checks(X, yb))
    _level_row("dt_multi", dt_chk.widest, reps, bw, f32, smem_bw,
               integer=True)
    del dt_chk
    _general_level_rows(X, K, "gbdt_multi", (1, 32, 512), reps, bw, f32,
                        smem_bw)
    _general_level_rows(X, 1, "gbdt_count", (1, 32), reps, bw, f32,
                        smem_bw)
    del X, Xh

    out = {"phase": "boosted_multi", "rows": rows, "holdout": holdout,
           "cols": cols, "classes": K,
           "folds": selector.validator.num_folds, "train_s": train_s,
           "stage_seconds": stage_seconds,
           "sweep_seconds": meta["sweep_seconds"],
           "group_errors": meta["group_errors"],
           "refit_seconds": meta["refit_seconds"],
           "sequential_fits": meta["sequential_fits"],
           "tree_binnings": meta["tree_binnings"],
           "train_s_earlier": BOOSTED_TRAIN_S_EARLIER,
           "winner": summary["bestModelType"],
           "winner_params": summary["bestModelParams"],
           "cv": [{"model": r["modelType"], "params": r["params"],
                   "f1": r["metricValue"], "error": r.get("error")}
                  for r in results],
           "holdout_f1": f1, "holdout_accuracy": metrics["Accuracy"],
           "holdout_logloss": metrics["LogLoss"],
           "attainable_f1": attainable,
           "f1_floor": BOOSTED_F1_SHARE * attainable,
           "seg_hist_launches": launches,
           "growers_hist_levels": meta["hist_levels"],
           "max_memory_allocated": peak, **served,
           "xgb_defaults": xgb_out, "count_and_subsample": cs_out,
           "levels_vs_plain": checks,
           "launches_total": launches + xgb_launches + sum(
               r["seg_hist_launches"] for r in cs_out.values())}
    emit(out)
    check(tuple(proba.shape) == (holdout, K), f"proba shape {proba.shape}")
    check(bool(torch.isfinite(proba).all()), "non-finite probabilities")
    check(len(results) == 4, f"{len(results)} validation results, not 4")
    errors = [r["error"] for r in results if r.get("error")]
    check(not errors, f"candidates failed: {errors}")
    check(not meta["group_errors"],
          f"grid groups failed: {meta['group_errors']}")
    check(len(meta["sequential_fits"]) == 4 * 3 + 1,
          f"{len(meta['sequential_fits'])} sequential fits, not 13")
    # one matrix, one (dense) sketch: one binning serves every fit
    check(meta["tree_binnings"]["binnings"] == 1
          and sum(f["binnings_built"] for f in meta["sequential_fits"]) == 1,
          f"boosted_multi: {meta['tree_binnings']} binnings for one matrix")
    check(launches > 0 and launches == meta["hist_levels"],
          f"boosted_multi: seg_hist launches {launches} != the growers' "
          f"{meta['hist_levels']} histogram levels")
    check(summary["bestModelType"] == "OpXGBoostClassifier",
          f"boosted_multi: winner {summary['bestModelType']}, not the "
          f"softmax XGBoost")
    check(f1 >= BOOSTED_F1_SHARE * attainable,
          f"boosted_multi: holdout F1 {f1} below {BOOSTED_F1_SHARE} x the "
          f"attainable {attainable}")
    check(served["holdout_bitwise_after_load"],
          "boosted_multi: holdout scores after save/load differ")
    check(served["local_scorer_max_abs_diff"] <= 1e-6,
          f"boosted_multi: local scorer rows "
          f"{served['local_scorer_max_abs_diff']} from the batch")
    check(served["served_max_abs_diff"] <= 1e-6 and served["server_shed"] == 0
          and served["server_device_errors"] == 0,
          f"boosted_multi: served scores {served['served_max_abs_diff']} "
          f"from the in-memory model's, shed {served['server_shed']}, "
          f"device errors {served['server_device_errors']}")
    check(xgb_out["mode"] == "gbdt_multi"
          and xgb_launches == xgb_out["growers_hist_levels"] > 0,
          f"xgb_defaults: mode {xgb_out['mode']}, launches {xgb_launches} "
          f"vs {xgb_out['growers_hist_levels']} levels")
    check(np.isfinite(xgb_out["holdout_logloss"]),
          "xgb_defaults: non-finite LogLoss")
    for name, r in cs_out.items():
        check(r["seg_hist_launches"] == r["growers_hist_levels"] > 0,
              f"{name}: launches {r['seg_hist_launches']} vs "
              f"{r['growers_hist_levels']} levels")
        check(r["holdout_aupr"] >= BOOSTED_AUPR_FLOOR,
              f"{name}: holdout AuPR {r['holdout_aupr']} below "
              f"{BOOSTED_AUPR_FLOOR}")
    for name, c in checks.items():
        if name == "decision_tree":
            check(c["bitwise_equal"] and c["levels"] > 0,
                  f"decision tree: {c['levels_unequal']} of {c['levels']} "
                  f"levels differ from the plain version")
        else:
            check(c["tol_ratio"] <= 1.0 and c["levels"] > 0,
                  f"{name}: kernel vs plain error {c['max_abs_err']} "
                  f"beyond the tolerance")
        check(c["splits"] > 0, f"{name}: no split grown")
    return out


# ---------------------------------------------------------------------------
# comparisons of two fits' trees, and the level checks of the CSR path
# ---------------------------------------------------------------------------

def _leaf_ids(binned, feat, thresh, depth: int) -> torch.Tensor:
    """Every row's leaf under one tree (heap arrays)."""
    n = binned.shape[0]
    rows = torch.arange(n, device=binned.device)
    node = torch.zeros(n, dtype=torch.int64, device=binned.device)
    for level in range(depth):
        heap = (2 ** level - 1) + node
        x = binned[rows, feat[heap].long()]
        node = 2 * node + gk.route_right(x, thresh[heap]).long()
    return node


def _compare_ensembles(a, b, binned) -> dict:
    """Two boosted models' trees, round by round, over the rows of
    ``binned`` (the original columns): ``identical`` splits, ``tied``
    (other splits that cut the rows into the same leaves: exact ties of
    gain), ``differ`` (another partition); the largest leaf difference of
    the rows' leaves in the trees that partition alike."""
    depth = int(np.log2(a.feat.shape[1] + 1))
    out = {"rounds": [int(a.feat.shape[0]), int(b.feat.shape[0])],
           "identical": 0, "tied": 0, "differ": 0, "first_differ": None,
           "max_leaf_diff": 0.0}
    for t in range(min(a.feat.shape[0], b.feat.shape[0])):
        if torch.equal(a.feat[t], b.feat[t]) and torch.equal(a.thresh[t],
                                                             b.thresh[t]):
            out["identical"] += 1
            diff = (a.leaf[t] - b.leaf[t]).abs().max()
        else:
            la = _leaf_ids(binned, a.feat[t], a.thresh[t], depth)
            lb = _leaf_ids(binned, b.feat[t], b.thresh[t], depth)
            pairs = torch.unique(la * (1 << depth) + lb).numel()
            if pairs == torch.unique(la).numel() == torch.unique(lb).numel():
                out["tied"] += 1
                diff = (a.leaf[t][la] - b.leaf[t][lb]).abs().max()
            else:
                out["differ"] += 1
                if out["first_differ"] is None:
                    out["first_differ"] = t
                continue
        out["max_leaf_diff"] = max(out["max_leaf_diff"], float(diff))
    return out


def _first_divergence(a, b, binned, y: torch.Tensor, lam: float) -> dict:
    """Where two binary boosted fits' trees first cut a node's rows into
    different sets (round ``t``, the first whose partition differs; every
    earlier tree cut the rows alike, so both fits grew round ``t`` from
    the same margins, those of ``a``'s earlier trees): the node's level
    and rows, and the float64 gain (G_L^2 / (H_L + lam) + G_R^2 / (H_R +
    lam) - G^2 / (H + lam)) of each fit's split of them.  Two gains within
    float32 rounding of each other are a tie the two histograms' rounding
    broke either way."""
    depth = int(np.log2(a.feat.shape[1] + 1))
    t = _compare_ensembles(a, b, binned)["first_differ"]
    if t is None:
        return {"round": None}
    F = a.base_score + _margin_of_rounds(a, binned, t, depth)
    p = torch.sigmoid(F.to(torch.float64))
    g, h = p - y.to(torch.float64), torch.clamp(p * (1 - p), min=1e-6)
    rows = torch.arange(binned.shape[0], device=binned.device)
    na = torch.zeros_like(rows)
    nb = torch.zeros_like(rows)

    def gain(m, right):
        G, H = g[m].sum(), h[m].sum()
        GR, HR = g[m & right].sum(), h[m & right].sum()
        GL, HL = G - GR, H - HR
        return float(GL * GL / (HL + lam) + GR * GR / (HR + lam)
                     - G * G / (H + lam))

    for level in range(depth):
        ha, hb = (2 ** level - 1) + na, (2 ** level - 1) + nb
        ra = gk.route_right(binned[rows, a.feat[t][ha].long()],
                            a.thresh[t][ha])
        rb = gk.route_right(binned[rows, b.feat[t][hb].long()],
                            b.thresh[t][hb])
        for node in torch.unique(na).tolist():
            m = na == node
            if torch.equal(ra[m], rb[m]) or torch.equal(ra[m], ~rb[m]):
                continue
            ga, gb = gain(m, ra), gain(m, rb)
            return {"round": t, "level": level, "node_rows": int(m.sum()),
                    "gain_a": ga, "gain_b": gb,
                    "rel_gap": abs(ga - gb) / max(abs(ga), abs(gb), 1e-30)}
        na = 2 * na + ra.long()
        nb = 2 * nb + rb.long()
    return {"round": t, "level": None}


def _margin_of_rounds(model, binned, t: int, depth: int):
    """The sum of ``model``'s first ``t`` trees' leaves on ``binned``'s
    rows (N,)."""
    if t == 0:
        return torch.zeros(binned.shape[0], device=binned.device)
    return gk.predict_ensemble(binned, model.feat[:t], model.thresh[:t],
                               model.leaf[:t], depth)[:, 0]


def _boosted_levels(est, binned, edges, y: np.ndarray, hist_fn) -> dict:
    """WIDE_CHECK_ROUNDS rounds of ``est``'s chain on all rows, every level
    built and checked by ``hist_fn``."""
    dev = binned.device
    p0 = float(np.clip(y.mean(), 1e-6, 1 - 1e-6))
    grown = boost_chains(
        [est], binned, edges, torch.from_numpy(y).to(dev),
        torch.ones((1, binned.shape[0]), device=dev),
        torch.tensor([float(np.log(p0 / (1 - p0)))]), [], hist_fn=hist_fn)
    return {**hist_fn.summary(), "rounds": len(grown.trees[0]),
            "splits": sum(int((t.thresh < 32).sum()) for t in grown.trees[0])}


def _fit_row(est, X, y, Xh, yh) -> Tuple[object, dict]:
    """One boosted fit on the card: its model and its line (seconds,
    rounds, ms a round, launches, histogram levels and the CSR's share of
    them, holdout AuPR)."""
    gk.seg_level_hists.launches = 0
    sparse0 = gk.sparse_level_hists.levels
    model, fit_s = _timed_fit(est, X, y)
    meta = est.metadata
    score = model.predict_batch(Xh).probability[:, 1]
    return model, {
        "fit_s": fit_s, **meta["fit_timing"],
        "rounds_grown": meta["rounds_grown"], "rounds_kept": meta["best_len"],
        "ms_per_round": meta["fit_timing"]["boosting_s"]
        / meta["rounds_grown"] * 1e3,
        "seg_hist_launches": gk.seg_level_hists.launches,
        "growers_hist_levels": meta["hist_levels"],
        "csr_levels": gk.sparse_level_hists.levels - sparse0,
        "efb_width": meta["efb_width"], "goss": meta["goss"],
        "holdout_aupr": aupr(yh.to(score.device), score)}


# ---------------------------------------------------------------------------
# the xgb_wide phase: BASELINE.md config 5, XGBoost on wide sparse rows
# (500k x 2000 in the smoke)
# ---------------------------------------------------------------------------

def make_sparse_data(rows: int, cols: int, density: float = 0.05,
                     seed: int = 17):
    """examples/bench_xgb_wide.py's ``make_sparse_data`` recipe (a wide,
    mostly zero matrix with signal in 25 columns), as numpy arrays, with
    the label's noiseless score ``z`` beside it: (X, y, z)."""
    rng = np.random.default_rng(seed)
    X = np.zeros((rows, cols), np.float32)
    nnz_per_row = max(1, int(cols * density))
    cols_idx = rng.integers(0, cols, size=(rows, nnz_per_row))
    vals = rng.exponential(1.0, size=(rows, nnz_per_row)).astype(np.float32)
    rows_idx = np.repeat(np.arange(rows), nnz_per_row)
    X[rows_idx, cols_idx.ravel()] = vals.ravel()
    informative = rng.choice(cols, 25, replace=False)
    z = X[:, informative] @ rng.normal(size=25).astype(np.float32)
    y = (z + 0.5 * rng.normal(size=rows) > np.median(z)).astype(np.float32)
    return X, y, z


def _wide_seg_rows(binned, goss, reps: int, bw: float, f32: float,
                   smem_bw: float) -> list:
    """``seg_hist`` lines with ``path`` "xgb_wide": the fit's binned matrix
    (d = 2000) at M = 1, 32 and 512 on every row, and one GOSS sample's
    level (k_top + k_rest rows, M = 32); float channels (a gradient in
    [-1, 1], a hessian in [0, 0.25]) at random slots."""
    dev = binned.device
    gen = torch.Generator(device=dev).manual_seed(5)
    n = binned.shape[0]
    ch = torch.cat([torch.rand((n, 1), device=dev, generator=gen) * 2 - 1,
                    torch.rand((n, 1), device=dev, generator=gen) * 0.25],
                   1).contiguous()
    rows = []
    for M in (1, 32, 512):
        slot = torch.randint(0, M, (n,), dtype=torch.int32, device=dev,
                             generator=gen)
        rows.append(_level_row("xgb_wide", (binned, slot, ch, M, 32), reps,
                               bw, f32, smem_bw, integer=False))
        del slot
    idx, _ = gk.goss_select(ch[:, 0].abs(), 13, 0, 0, *goss)
    sample = gk.goss_rows(binned, idx)
    chs = ch[idx].contiguous()
    slot = torch.randint(0, 32, (sample.shape[0],), dtype=torch.int32,
                         device=dev, generator=gen)
    row = _level_row("xgb_wide", (sample, slot, chs, 32, 32), reps, bw, f32,
                     smem_bw, integer=False)
    row["goss_sample"] = list(goss)
    rows.append(row)
    return rows


def phase_xgb_wide(rows: int, hold: int, reps: int, bw: float, f32: float,
                   smem_bw: float) -> dict:
    """BASELINE.md config 5 on the card: ``make_sparse_data``'s
    ``rows + hold`` x 2000 rows at 5% density (the first ``rows`` to
    train, the last ``hold`` held out), one ``OpXGBoostClassifier`` at the reference's defaults
    through ``fit_raw``, as ``bench_xgb_wide.run`` fits it; the CSR leg
    (two depth-6 fits with and without ``TMOG_SPARSE_HIST=1``, trees and
    AuPR compared, two rounds of each leg's levels held against the plain
    version); ``seg_hist`` lines at d = 2000."""
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    Xn, yn, zn = make_sparse_data(rows + hold, WIDE_COLS, WIDE_DENSITY,
                                  WIDE_SEED)
    Xall = torch.from_numpy(Xn).to(dev)
    del Xn
    X, Xh = Xall[:rows], Xall[rows:]
    y, yh = yn[:rows], torch.from_numpy(yn[rows:])
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    attainable = {
        "train": aupr(torch.from_numpy(y), torch.from_numpy(zn[:rows])),
        "holdout": aupr(yh, torch.from_numpy(zn[rows:]))}
    density = float((X[::1000] != 0).float().mean())

    # the reference's XGBoost defaults for binary selection
    est = OpXGBoostClassifier(num_round=200, eta=0.02, max_depth=10,
                              min_child_weight=1.0, gamma=0.8,
                              early_stopping_rounds=20, seed=13)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kinds = dict(SKETCH_KINDS)
    built = MEMO_STATS["binnings"]
    model, fit = _fit_row(est, X, y, Xh, yh)
    peak = torch.cuda.max_memory_allocated()
    kinds = {k: SKETCH_KINDS[k] - kinds[k] for k in kinds}
    train_aupr = aupr(torch.from_numpy(y).to(dev),
                      model.predict_batch(X).probability[:, 1])
    binned = binned_for_edges(X, model.edges)
    binnings = MEMO_STATS["binnings"] - built
    # the EFB decision: the fit's (the JAX rule) and the widest bundling
    # any plan could make on this matrix
    t0 = time.perf_counter()
    best = gk.bundle_features(binned, model.edges, 32, min_width_ratio=1.0)
    plan_s = time.perf_counter() - t0
    efb = {"fit_efb_width": fit["efb_width"],
           "rule_ratio": gk.EFB_MIN_WIDTH_RATIO,
           "best_width": None if best is None else best.width,
           "best_ratio": None if best is None else best.width_ratio,
           "plan_s": plan_s}

    # the CSR leg: depth 6 (below GOSS's depth gate), with and without it
    os.environ["TMOG_SPARSE_HIST"] = "1"
    try:
        t0 = time.perf_counter()
        csr = prep_tree_csr(X, model.edges, binned)
        torch.cuda.synchronize()
        csr_s = time.perf_counter() - t0
        check(csr is not None, "xgb_wide: the matrix did not qualify for "
              "the CSR histogram")
        nz_max = csr.nz_max
        legs = {}

        def leg():
            return OpXGBoostClassifier(max_depth=WIDE_CSR_DEPTH,
                                       num_round=WIDE_CSR_ROUNDS,
                                       early_stopping_rounds=0)
        m_csr, legs["csr"] = _fit_row(leg(), X, y, Xh, yh)
        sparse_chk = _boosted_levels(
            OpXGBoostClassifier(max_depth=WIDE_CSR_DEPTH,
                                num_round=WIDE_CHECK_ROUNDS,
                                early_stopping_rounds=0),
            binned, model.edges, y, _LevelCheck(
                lambda b, slot, ch, M, B: gk.sparse_level_hists(
                    csr, slot, ch, M, B)))
    finally:
        del os.environ["TMOG_SPARSE_HIST"]
    m_dense, legs["dense"] = _fit_row(leg(), X, y, Xh, yh)
    dense_chk = _boosted_levels(
        OpXGBoostClassifier(max_depth=WIDE_CSR_DEPTH,
                            num_round=WIDE_CHECK_ROUNDS,
                            early_stopping_rounds=0),
        binned, model.edges, y, _LevelCheck())
    trees = _compare_ensembles(m_csr, m_dense, binned)
    trees["first_divergence"] = _first_divergence(
        m_csr, m_dense, binned, torch.from_numpy(y).to(dev), 1.0)
    for name, r in legs.items():
        r["csr_share"] = r["csr_levels"] / r["growers_hist_levels"]
    del m_csr, m_dense, csr, Xall, X, Xh
    torch.cuda.empty_cache()

    seg_rows = _wide_seg_rows(binned, fit["goss"], reps, bw, f32, smem_bw)
    del binned
    launches = (fit["seg_hist_launches"] + legs["csr"]["seg_hist_launches"]
                + legs["dense"]["seg_hist_launches"])
    out = {"phase": "xgb_wide", "rows": rows, "holdout": hold,
           "cols": WIDE_COLS, "density": density, "data_s": data_s,
           "num_round": est.num_round, "max_depth": est.max_depth,
           "eta": est.eta, "gamma": est.gamma,
           "early_stopping_rounds": est.early_stopping_rounds,
           "sketch_kinds": kinds, "binnings_built": binnings, **fit,
           "train_aupr": train_aupr, "attainable_aupr": attainable,
           "aupr_floor": {k: WIDE_AUPR_SHARE * v
                          for k, v in attainable.items()},
           "efb": efb, "max_memory_allocated": peak,
           "csr": {"build_s": csr_s, "nz_max": nz_max,
                   "legs": legs, "trees": trees,
                   "aupr_gap": abs(legs["csr"]["holdout_aupr"]
                                   - legs["dense"]["holdout_aupr"]),
                   "levels_vs_plain": {"csr": sparse_chk,
                                       "dense": dense_chk}},
           "launches_total": launches}
    emit(out)
    check(kinds["sparse_aware"] > 0 and kinds["dense"] == 0,
          f"xgb_wide: the fit took the sketches {kinds}, not the "
          f"nonzero-aware one")
    check(fit["rounds_grown"] <= 200 and fit["rounds_kept"] >= 1,
          f"xgb_wide: {fit['rounds_grown']} rounds grown")
    check(fit["goss"] is not None, "xgb_wide: GOSS did not engage")
    check(fit["seg_hist_launches"] == fit["growers_hist_levels"] > 0,
          f"xgb_wide: launches {fit['seg_hist_launches']} vs "
          f"{fit['growers_hist_levels']} levels")
    for k, floor in out["aupr_floor"].items():
        got = train_aupr if k == "train" else fit["holdout_aupr"]
        check(got >= floor, f"xgb_wide: {k} AuPR {got} below {floor}")
    for name, r in legs.items():
        check(r["seg_hist_launches"] + r["csr_levels"]
              == r["growers_hist_levels"] > 0,
              f"CSR leg {name}: {r['seg_hist_launches']} launches + "
              f"{r['csr_levels']} CSR levels vs {r['growers_hist_levels']}")
    check(legs["csr"]["csr_share"] == 1.0 and legs["dense"]["csr_levels"] == 0,
          f"CSR leg: CSR shares {legs['csr']['csr_share']} / "
          f"{legs['dense']['csr_share']}")
    # the legs' trees are equal up to ties: where they first cut a node
    # differently, the two cuts' gains are equal within float32 rounding
    # (the kernel's float32 sums against the CSR's float64 ones; PERF.md)
    div = trees["first_divergence"]
    check(trees["rounds"][0] == trees["rounds"][1]
          and (div["round"] is None
               or (div.get("level") is not None
                   and div["rel_gap"] <= WIDE_TIE_GAP)),
          f"CSR leg: trees differ beyond ties: {trees}")
    check(out["csr"]["aupr_gap"] <= 1e-3,
          f"CSR leg: holdout AuPR gap {out['csr']['aupr_gap']}")
    for name, c in out["csr"]["levels_vs_plain"].items():
        check(c["tol_ratio"] <= 1.0 and c["levels"] > 0 and c["splits"] > 0,
              f"CSR leg {name}: levels vs plain {c}")
    out["seg_hist_rows"] = seg_rows
    return out


# ---------------------------------------------------------------------------
# the efb line: exclusive feature bundling on the Titanic demo's matrix
# ---------------------------------------------------------------------------

def _bundle_conflicts(plan, binned: torch.Tensor) -> int:
    """Rows of ``binned`` in which two members of one bundle of ``plan``
    are nonzero (their bundled bin keeps the larger member's)."""
    dev = binned.device
    mem, slot = [], []
    for c, spec in enumerate(s for s in plan.plan if isinstance(s, tuple)):
        for orig, _base, _end in spec:
            mem.append(orig)
            slot.append(c)
    mem = torch.tensor(mem, dtype=torch.int64, device=dev)
    slot = torch.tensor(slot, dtype=torch.int64, device=dev)
    rows = 0
    for a in range(0, binned.shape[0], 1 << 16):
        act = (binned[a:a + (1 << 16)].index_select(1, mem) > 0).to(
            torch.int32)
        per = torch.zeros((act.shape[0], int(slot.max()) + 1),
                          dtype=torch.int32, device=dev)
        per.index_add_(1, slot, act)
        rows += int((per >= 2).any(1).sum())
    return rows


def _efb_line(X: torch.Tensor, y: np.ndarray, Xh: torch.Tensor,
              yh: torch.Tensor, reps: int, bw: float, f32: float,
              smem_bw: float) -> dict:
    """The JAX rule's bundling plan of the demo's checked matrix as the
    port computes it (d -> d_b, bundles, members, the rows outside the
    plan's sample that put two members of a bundle to work; or its
    decline with the width ratio the widest plan reaches), and one
    ``OpXGBoostClassifier(max_depth=EFB_DEPTH, num_round=EFB_ROUNDS)`` fit
    with ``TMOG_EFB`` at ``auto`` and at ``0``: ms a round, holdout AuPR,
    trees compared; a ``seg_hist`` line at the bundled width."""
    edges, binned = prep_tree_inputs(X, 32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eb = maybe_bundle(binned, edges, 32)       # the fit's plan (memoized)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    plan = None if eb is None else eb.bundles
    widest = plan or gk.bundle_features(binned, edges, 32,
                                        min_width_ratio=1.0)
    multi = ([] if widest is None else
             [len(spec) for spec in widest.plan if isinstance(spec, tuple)])
    out = {"phase": "efb", "N": X.shape[0], "d": X.shape[1],
           "bundles": plan is not None, "plan_and_encode_s": plan_s,
           "d_b": None if widest is None else widest.width,
           "width_ratio": None if widest is None else widest.width_ratio,
           "rule_ratio": gk.EFB_MIN_WIDTH_RATIO,
           "bundle_count": len(multi), "members": sum(multi),
           "largest_bundle": max(multi, default=0),
           "conflicted_rows": (None if plan is None
                               else _bundle_conflicts(plan, binned))}
    fits, models = {}, {}
    for mode in ("auto", "0"):
        os.environ["TMOG_EFB"] = mode
        try:
            models[mode], fits[mode] = _fit_row(
                OpXGBoostClassifier(max_depth=EFB_DEPTH, num_round=EFB_ROUNDS,
                                    early_stopping_rounds=0), X, y, Xh, yh)
        finally:
            del os.environ["TMOG_EFB"]
    out["fits"] = fits
    out["launches_total"] = sum(f["seg_hist_launches"] for f in fits.values())
    if plan is not None:
        out["trees"] = _compare_ensembles(models["auto"], models["0"],
                                          binned)
        out["aupr_gap"] = abs(fits["auto"]["holdout_aupr"]
                              - fits["0"]["holdout_aupr"])
    del models
    emit(out)
    for mode, f in fits.items():
        check(f["seg_hist_launches"] == f["growers_hist_levels"] > 0,
              f"efb {mode}: launches {f['seg_hist_launches']} vs "
              f"{f['growers_hist_levels']} levels")
    check((fits["auto"]["efb_width"] is not None) == (plan is not None)
          and fits["0"]["efb_width"] is None,
          f"efb: the fits grew at {fits['auto']['efb_width']} / "
          f"{fits['0']['efb_width']}, the plan says {out['d_b']}")
    if plan is not None:
        t = out["trees"]
        # the plan is decided on a row sample: rows outside it where two
        # members of a bundle are nonzero keep only the larger encoded
        # bin, so the bundled trees match only on a conflict-free matrix
        if out["conflicted_rows"] == 0:
            check(t["differ"] == 0 and t["max_leaf_diff"] <= 1e-6,
                  f"efb: bundled and unbundled trees differ beyond ties: "
                  f"{t}")
        check(out["aupr_gap"] <= 1e-3, f"efb: holdout AuPR gap "
              f"{out['aupr_gap']}")
        # the kernel at the bundled width: a boosted level's channels
        dev = X.device
        gen = torch.Generator(device=dev).manual_seed(9)
        n = eb.binned.shape[0]
        ch = torch.cat([torch.rand((n, 1), device=dev, generator=gen) * 2 - 1,
                        torch.rand((n, 1), device=dev, generator=gen) * 0.25],
                       1).contiguous()
        slot = torch.randint(0, 32, (n,), dtype=torch.int32, device=dev,
                             generator=gen)
        out["seg_hist_row"] = _level_row(
            "efb", (eb.binned, slot, ch, 32, 32), reps, bw, f32, smem_bw,
            integer=False)
    return out


# ---------------------------------------------------------------------------
# the glm_isotonic phase: a poisson GLM at 1M x 500, the isotonic calibrator
# on the slice's holdout scores
# ---------------------------------------------------------------------------

def _poisson_deviance(y: torch.Tensor, mu: torch.Tensor) -> float:
    """The mean Poisson deviance 2 (y log(y / mu) - (y - mu))."""
    y, mu = y.to(torch.float64), mu.to(torch.float64)
    t = torch.where(y > 0, y * torch.log(y / mu), 0.0)
    return float(2 * (t - (y - mu)).mean())


def phase_glm_isotonic(data, served: dict) -> dict:
    """``OpGeneralizedLinearRegression(family="poisson")`` on the slice's
    1M x 500 columns with a count label from a log-linear rate of its own
    seed (GLM_INFORMATIVE columns): seconds, IRLS steps, holdout deviance
    against the true rate's and the intercept-only model's; then
    ``IsotonicRegressionCalibrator`` on the slice's boosted model's
    100 000 holdout scores: seconds, blocks, monotonicity, calibrated
    against raw holdout AuPR."""
    train, hold, _ = data
    dev = torch.device("cuda")
    cols = len([k for k in train.columns if k.startswith("f")])

    names = [f"f{j}" for j in range(cols)]
    X, Xh = (_device_matrix(ds, names, dev) for ds in (train, hold))
    rng = np.random.default_rng(GLM_SEED)
    beta = np.zeros(cols, np.float32)
    beta[rng.choice(cols, GLM_INFORMATIVE, replace=False)] = rng.normal(
        size=GLM_INFORMATIVE) * GLM_COEF_SD
    bt = torch.from_numpy(beta).to(dev)
    mu, mu_h = (torch.exp(M @ bt + GLM_INTERCEPT) for M in (X, Xh))
    y = torch.from_numpy(rng.poisson(mu.cpu().numpy()).astype(np.float32))
    yh = torch.from_numpy(rng.poisson(mu_h.cpu().numpy()).astype(
        np.float32)).to(dev)
    est = OpGeneralizedLinearRegression(family="poisson")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    glm = est.fit_raw(X, y.numpy(), device=dev)
    torch.cuda.synchronize()
    glm_s = time.perf_counter() - t0
    pred = glm.predict_batch(Xh).prediction
    dev_fit = _poisson_deviance(yh, pred)
    dev_true = _poisson_deviance(yh, mu_h)
    dev_null = _poisson_deviance(yh, torch.full_like(yh, float(y.mean())))
    coef_err = float((glm.coef - bt).abs().max())
    del X, Xh, mu, mu_h

    proba = served["proba"][:, 1]
    y_hold = torch.from_numpy(np.asarray(served["hold"]["label"].values,
                                         np.float64))
    cal = IsotonicRegressionCalibrator()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    iso = cal.fit_raw(proba, y_hold, device=dev)
    torch.cuda.synchronize()
    iso_s = time.perf_counter() - t0
    calibrated = iso.predict_batch(proba[:, None]).prediction
    order = torch.argsort(proba.to(torch.float64))
    steps = calibrated[order]
    monotone = bool((steps[1:] >= steps[:-1]).all())
    raw_aupr = aupr(y_hold, proba.cpu())
    cal_aupr = aupr(y_hold, calibrated.cpu())
    out = {"phase": "glm_isotonic", "rows": int(y.shape[0]),
           "holdout": int(yh.shape[0]), "cols": cols,
           "glm": {"family": "poisson", "fit_s": glm_s,
                   "n_iter": est.metadata["n_iter"],
                   "holdout_deviance": dev_fit,
                   "true_rate_deviance": dev_true,
                   "null_deviance": dev_null,
                   "deviance_limit": GLM_DEVIANCE_RATIO * dev_true,
                   "max_coef_err": coef_err,
                   "intercept": glm.intercept},
           "isotonic": {"rows": int(proba.shape[0]), "fit_s": iso_s,
                        "blocks": cal.metadata["blocks"],
                        "monotone": monotone, "raw_aupr": raw_aupr,
                        "calibrated_aupr": cal_aupr,
                        "aupr_gap": abs(cal_aupr - raw_aupr),
                        "calibrated_range": [float(calibrated.min()),
                                             float(calibrated.max())]}}
    emit(out)
    check(np.isfinite(dev_fit) and dev_fit <= GLM_DEVIANCE_RATIO * dev_true
          and dev_fit < dev_null,
          f"glm: holdout deviance {dev_fit} against the true rate's "
          f"{dev_true} and the null {dev_null}")
    check(monotone and out["isotonic"]["aupr_gap"] <= ISO_AUPR_GAP,
          f"isotonic: monotone {monotone}, AuPR {cal_aupr} vs raw "
          f"{raw_aupr}")
    check(0.0 <= float(calibrated.min()) and float(calibrated.max()) <= 1.0,
          "isotonic: calibrated values outside [0, 1]")
    return out


# ---------------------------------------------------------------------------
# the iris phase: the reference's Iris demo at 1M + 100k rows
# ---------------------------------------------------------------------------

def make_iris(n: int, seed: int = IRIS_SEED):
    """(X (n, 4), y (n,)): three balanced classes, each row drawn from its
    class's diagonal Gaussian (the reference CSV's class means and
    standard deviations)."""
    rng = np.random.default_rng(seed)
    y = np.arange(n) % 3
    rng.shuffle(y)
    X = IRIS_MEANS[y] + IRIS_SDS[y] * rng.normal(size=(n, 4))
    return X, y.astype(np.float64)


def _iris_dataset(X, y) -> ColumnarDataset:
    cols = {c: FeatureColumn.from_values(ft.Real, X[:, j])
            for j, c in enumerate(IRIS_COLS)}
    cols["label"] = FeatureColumn.from_values(ft.RealNN, y)
    return ColumnarDataset(cols)


def build_iris():
    """examples/op_iris_simple.py's DAG with this package's imports: 4
    Reals -> transmogrify -> SanityChecker -> the multiclass selector on a
    stratified train/validation split over LR {0.01, 0.1} and the MLP at
    hidden layers [5, 4] and [10] (300 steps of 0.1)."""
    label = FeatureBuilder.RealNN("label").as_response()
    predictors = [FeatureBuilder.Real(c).as_predictor() for c in IRIS_COLS]
    checked = SanityChecker().set_input(label, transmogrify(predictors)
                                        ).get_output()
    selector = MultiClassificationModelSelector.with_train_validation_split(
        models_and_parameters=[
            (OpLogisticRegression(), grid(reg_param=[0.01, 0.1])),
            (OpMultilayerPerceptronClassifier(max_iter=300, step_size=0.1),
             grid(hidden_layers=[[5, 4], [10]])),
        ])
    prediction = selector.set_input(label, checked).get_output()
    return prediction, label, checked, selector


def phase_iris(rows: int, holdout: int) -> dict:
    """The Iris demo's own DAG and grid on an Iris-shaped frame: the
    split's kept labels, both families' validation F1, the winner, the
    MLP's steps and fit seconds, holdout F1 against IRIS_F1_SHARE x the
    attainable."""
    t0 = time.perf_counter()
    X, y = make_iris(rows + holdout)
    train, hold = (_iris_dataset(X[:rows], y[:rows]),
                   _iris_dataset(X[rows:], y[rows:]))
    ll = np.stack([(-0.5 * ((X[rows:] - IRIS_MEANS[k]) / IRIS_SDS[k]) ** 2
                    - np.log(IRIS_SDS[k])).sum(1) for k in range(3)], 1)
    attainable = multiclass_metrics(torch.from_numpy(y[rows:]),
                                    torch.from_numpy(ll.argmax(1)), 3)["F1"]
    data_s = time.perf_counter() - t0
    prediction, label, checked, selector = build_iris()
    wf = OpWorkflow().set_result_features(prediction, label) \
        .set_input_data(train)
    torch.cuda.synchronize()
    gk.seg_level_hists.launches = 0
    t0 = time.perf_counter()
    model = wf.train()
    train_s = time.perf_counter() - t0
    launches = gk.seg_level_hists.launches
    scored, metrics = model.score_and_evaluate(
        Evaluators.MultiClassification.f1(), data=hold)
    proba = scored[prediction.name].values.probability
    meta = selector.metadata
    summary = meta["model_selector_summary"]
    results = summary["validationResults"]
    mlp_fits = [f for f in meta["sequential_fits"]
                if f["model"] == "OpMultilayerPerceptronClassifier"]
    f1 = float(metrics["F1"])
    out = {"phase": "iris", "rows": rows, "holdout": holdout,
           "data_s": data_s, "train_s": train_s,
           "stage_seconds": model.stage_seconds,
           "sweep_seconds": meta["sweep_seconds"],
           "group_errors": meta["group_errors"],
           "labels_kept": summary["dataPrepResults"]["labelsKept"],
           "dropped_columns": checked.origin_stage.metadata["summary"]
           ["dropped"],
           "validation": [{"model": r["modelType"], "params": r["params"],
                           "f1": r["metricValue"], "error": r.get("error")}
                          for r in results],
           "winner": summary["bestModelType"],
           "winner_params": summary["bestModelParams"],
           "mlp_fits": mlp_fits, "holdout_f1": f1,
           "holdout_accuracy": metrics["Accuracy"],
           "attainable_f1": float(attainable),
           "f1_floor": IRIS_F1_SHARE * float(attainable),
           "seg_hist_launches": launches}
    emit(out)
    check(tuple(proba.shape) == (holdout, 3), f"proba shape {proba.shape}")
    check(bool(torch.isfinite(proba).all()), "non-finite probabilities")
    check(len(results) == 4, f"{len(results)} validation results, not 4")
    errors = [r["error"] for r in results if r.get("error")]
    check(not errors, f"candidates failed: {errors}")
    check(not meta["group_errors"],
          f"grid groups failed: {meta['group_errors']}")
    check("SoftmaxGridGroup" in meta["sweep_seconds"],
          f"the softmax group did not run: {sorted(meta['sweep_seconds'])}")
    check(len(mlp_fits) >= 2 and all(f["n_iter"] > 0 for f in mlp_fits),
          f"iris: MLP fits {mlp_fits}")
    check(summary["dataPrepResults"]["labelsKept"] == [0.0, 1.0, 2.0],
          f"iris: kept labels {summary['dataPrepResults']['labelsKept']}")
    check(f1 >= IRIS_F1_SHARE * attainable,
          f"iris: holdout F1 {f1} below {IRIS_F1_SHARE} x the attainable "
          f"{attainable}")
    return out


def phase_serve_profile(served: list, rows: list) -> None:
    """Single-row requests of each saved-and-loaded model under
    torch.profiler: the card's busy time, idle share, device ops and
    copies a request (the profiler's own overhead lengthens the wall).
    Runs last: a session with CPU activity makes later CUDA-only sessions
    drop device events (the seg_hist phase's check saw it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {"phase": "serve_profile", "requests": len(rows)}
    for name, model in served:
        scorer = score_function_batch(model)
        scorer(rows[:1])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for r in rows:
                scorer([r])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
        n = len(rows)
        out[name] = {"profiled_wall_ms": wall_ms / n,
                     "device_busy_ms": busy_ms / n,
                     "device_idle_share": 1 - busy_ms / wall_ms,
                     "device_ops": len(dev) / n,
                     "device_copies": sum(1 for e in dev
                                          if "Memcpy" in e.name) / n}
    emit(out)
    check(all(out[name]["device_ops"] > 0 for name, _ in served),
          "serve_profile: no device event in a request")


def _serve_model(m: dict, rows: list, tmp: str) -> dict:
    """Save, load, batch, CSV and served scores of one trained model."""
    name, model, pred, hold = m["name"], m["model"], m["pred"], m["hold"]
    path = os.path.join(tmp, name)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.save(path)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = OpWorkflowModel.load(path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0

    # the 100k holdout, in memory vs after the round trip, on the card
    t0 = time.perf_counter()
    proba = loaded.score(hold)[pred.name].values.probability
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    bitwise_holdout = bool(torch.equal(proba, m["proba"]))

    # CSV_ROWS holdout rows through a CSV file, floats written by repr
    n_csv = min(CSV_ROWS, len(hold))
    names = [n for n in hold.names()]
    csv_path = os.path.join(tmp, f"{name}.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(names)
        cols = [hold[n].values[:n_csv] for n in names]
        for i in range(n_csv):
            w.writerow([repr(float(c[i])) for c in cols])
    t0 = time.perf_counter()
    csv_proba = loaded.score(CSVReader(csv_path))[pred.name].values.probability
    torch.cuda.synchronize()
    csv_s = time.perf_counter() - t0
    mem_proba = model.score(hold.slice(0, n_csv))[pred.name] \
        .values.probability
    csv_equal = bool(torch.equal(csv_proba, mem_proba))
    os.remove(csv_path)

    split = _request_split(loaded, rows[:SPLIT_REQUESTS])

    # the server: sequential single rows, a burst, 64-row requests
    seq_rows, burst_rows, big_rows = (rows[:SEQ_REQUESTS],
                                      rows[:BURST_REQUESTS],
                                      rows[:BIG_REQUESTS * 64])
    srv = ModelServer.from_path(path, name=name, max_batch=64,
                                max_queue_rows=2 * BURST_REQUESTS,
                                warmup_row=rows[0])
    served_p1 = {}
    t0 = time.perf_counter()
    srv.start()   # warms every bucket, largest first
    warmup_s = time.perf_counter() - t0
    try:
        seq_lat = []
        for i, r in enumerate(seq_rows):
            t = time.perf_counter()
            out = srv.score([r])
            seq_lat.append(time.perf_counter() - t)
            served_p1.setdefault(i, []).append(
                out[0][pred.name]["probability_1"])
        before = srv.snapshot()
        futures = [None] * len(burst_rows)

        def submit(k):
            for i in range(k, len(burst_rows), BURST_THREADS):
                futures[i] = srv.submit([burst_rows[i]])

        t0 = time.perf_counter()
        threads = [threading.Thread(target=submit, args=(k,))
                   for k in range(BURST_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        burst_out = [f.result(timeout=600) for f in futures]
        burst_s = time.perf_counter() - t0
        after = srv.snapshot()
        for i, out in enumerate(burst_out):
            check(isinstance(out[0], dict), f"serve {name}: burst request "
                  f"{i} not scored: {out[0]}")
            served_p1.setdefault(i, []).append(
                out[0][pred.name]["probability_1"])
        big_lat = []
        for k in range(BIG_REQUESTS):
            t = time.perf_counter()
            out = srv.score(big_rows[64 * k:64 * (k + 1)])
            big_lat.append(time.perf_counter() - t)
            for j, o in enumerate(out):
                served_p1.setdefault(64 * k + j, []).append(
                    o[pred.name]["probability_1"])
        traced = _traced_requests(srv, rows[:OBS_SERVE_REQUESTS])
        http = _http_check(srv, rows[:HTTP_ROWS], pred.name)
        snap = srv.snapshot()
    finally:
        srv.stop()
    ref = m["proba"][:, 1].cpu().numpy()
    idx = np.concatenate([[i] * len(v) for i, v in served_p1.items()])
    got = np.concatenate([v for v in served_p1.values()])
    diff = np.abs(got - ref[idx].astype(np.float64))
    batches = after["batches"] - before["batches"]
    padded = after["paddedRows"] - before["paddedRows"]
    out = {"model": name, "save_s": save_s, "load_s": load_s,
           "artifact_bytes": _dir_bytes(path),
           "holdout_rows": len(hold), "holdout_score_s": score_s,
           "holdout_bitwise_equal": bitwise_holdout,
           "csv_rows": n_csv, "csv_read_score_s": csv_s,
           "csv_equal_in_memory": csv_equal, "warmup_s": warmup_s,
           "request_split": split,
           "batch1": _pcts(seq_lat), "batch64": _pcts(big_lat),
           "burst": {"requests": len(burst_rows), "threads": BURST_THREADS,
                     "seconds": burst_s,
                     "rows_per_s": len(burst_rows) / burst_s,
                     "batches": batches,
                     "mean_batch": len(burst_rows) / max(batches, 1),
                     "padded_share": padded / max(padded + len(burst_rows),
                                                  1)},
           "served_scores": len(got),
           "served_max_abs_diff": float(diff.max()),
           "served_bitwise_share": float((diff == 0).mean()),
           "server_latency_ms": snap["latencyMs"],
           "batch_histogram": snap["batchSizeHistogram"],
           "shed": snap["shed"], "device_errors": snap["deviceErrors"],
           "host_fallbacks": snap["hostFallbacks"], "http": http,
           "traced": traced}
    what = f"serve {name}"
    check(bitwise_holdout, f"{what}: holdout scores after save/load differ "
          f"from the in-memory model's")
    check(csv_equal, f"{what}: CSV scores differ from in-memory scores")
    check(out["served_max_abs_diff"] <= 1e-6,
          f"{what}: served scores {out['served_max_abs_diff']} from the "
          f"in-memory model's")
    check(snap["shed"] == 0 and snap["deviceErrors"] == 0
          and snap["hostFallbacks"] == 0,
          f"{what}: shed {snap['shed']}, device errors "
          f"{snap['deviceErrors']}, host fallbacks {snap['hostFallbacks']}")
    return out, loaded


def _traced_requests(srv, rows: list) -> dict:
    """OBS_SERVE_REQUESTS single rows under a trace: each request's
    serve.admit span must hold its batch's serve.batch span, which holds
    the serve.execute span; then the Prometheus text of a snapshot must
    parse and count the snapshot's requests."""
    tracer = obs.start_trace("serve", capture_hlo=False)
    t0 = time.perf_counter()
    try:
        for r in rows:
            srv.score([r])
    finally:
        obs.stop_trace()
    traced_s = time.perf_counter() - t0
    spans = tracer.snapshot()
    by_id = {sp.span_id: sp for sp in spans}

    def parent(sp):
        return by_id.get(sp.parent_id)

    names = [sp.name for sp in spans]
    nested = sum(1 for sp in spans if sp.name == "serve.execute"
                 and parent(sp) is not None
                 and parent(sp).name == "serve.batch"
                 and parent(parent(sp)) is not None
                 and parent(parent(sp)).name == "serve.admit")
    snap = srv.snapshot()
    text = obs.prometheus_text(snap)
    samples = obs.parse_exposition(text)
    out = {"requests": len(rows), "seconds": traced_s,
           "admit": names.count("serve.admit"),
           "batch": names.count("serve.batch"),
           "execute": names.count("serve.execute"), "nested": nested,
           "prometheus_requests": samples["tmog_serving_requests_total"],
           "snapshot_requests": snap["requests"],
           "prometheus_lines": len(text.splitlines())}
    check(out["admit"] == out["nested"] == len(rows),
          f"serve: traced spans do not nest admit > batch > execute: {out}")
    check(out["prometheus_requests"] == snap["requests"],
          f"serve: the Prometheus request count differs from the JSON "
          f"snapshot's: {out}")
    return out


def _http_check(srv, rows: list, pred_name: str) -> dict:
    """A few requests over HTTP on 127.0.0.1: /score must give the
    server's own scores, /healthz ok, /metrics a snapshot."""
    from urllib.request import Request, urlopen

    httpd = make_http_server(srv, "127.0.0.1", 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        req = Request(base + "/score", data=json.dumps(
            {"rows": rows}).encode(), headers={
                "Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urlopen(req, timeout=120) as resp:
            scores = json.loads(resp.read())["scores"]
        score_s = time.perf_counter() - t0
        with urlopen(base + "/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        with urlopen(base + "/metrics", timeout=60) as resp:
            metrics = json.loads(resp.read())
        with urlopen(base + "/metrics?format=prometheus",
                     timeout=60) as resp:
            prom = obs.parse_exposition(resp.read().decode())
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=10)
    direct = srv.score(rows)
    same = [s[pred_name] == d[pred_name] for s, d in zip(scores, direct)]
    out = {"rows": len(rows), "score_s": score_s,
           "healthz": health["status"], "metrics_requests":
           metrics["requests"], "prometheus_requests":
           prom["tmog_serving_requests_total"], "same_scores": all(same)}
    check(len(scores) == len(rows) and all(same),
          f"http: /score differs from the server's scores")
    check(health["status"] == "ok", f"http: /healthz {health}")
    check(metrics["requests"] > 0, "http: /metrics shows no request")
    check(prom["tmog_serving_requests_total"] == metrics["requests"],
          f"http: /metrics?format=prometheus counts "
          f"{prom['tmog_serving_requests_total']} requests, the JSON "
          f"{metrics['requests']}")
    return out


def phase_serve(models: list, cols: int):
    """Save, load and serve the slice's boosted model and the selector's
    winner on the card, and score the committed model_v1 artifact.
    Returns the loaded models and some request rows for
    ``phase_serve_profile``."""
    tmp = os.path.join(REPO, "smoke_out")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    hold = models[0]["hold"]
    feats = [f"f{j}" for j in range(cols)]
    t0 = time.perf_counter()
    n = max(SEQ_REQUESTS, BURST_REQUESTS, BIG_REQUESTS * 64, HTTP_ROWS)
    Xh = np.stack([hold[f].values[:n] for f in feats], axis=1)
    rows = [dict(zip(feats, r)) for r in Xh.tolist()]
    rows_s = time.perf_counter() - t0
    gk.seg_level_hists.launches = 0
    try:
        results = [_serve_model(m, rows, tmp) for m in models]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    per_model = [r for r, _ in results]
    launches = gk.seg_level_hists.launches

    v1 = os.path.join(REPO, "tests", "fixtures", "model_v1")
    model = OpWorkflowModel.load(v1)
    got = model.score(CSVReader(os.path.join(
        REPO, "tests", "fixtures", "model_v1_input.csv")))
    p1 = got[model.result_features[0].name].values.probability
    expected = np.load(os.path.join(REPO, "tests", "fixtures",
                                    "model_v1_expected.npy"))
    v1_err = float(np.abs(p1[:, 1].cpu().numpy() - expected).max())
    emit({"phase": "serve", "request_rows_s": rows_s,
          "seg_hist_launches": launches, "models": per_model,
          "model_v1": {"device": str(p1.device), "rows": len(expected),
                       "max_abs_err": v1_err}})
    check(launches == 0, f"serve: {launches} seg_hist launches; scoring "
          f"and serving launch no kernel")
    check(p1.device.type == "cuda", "model_v1 did not score on the card")
    check(v1_err <= 1e-5, f"model_v1 scores {v1_err} from expected")
    return ([(m["name"], loaded) for m, (_, loaded) in zip(models, results)],
            rows[:SPLIT_REQUESTS])


# ---------------------------------------------------------------------------
# the serving_plane phase: per-bucket graphs, the host rung, the guarded
# swap and tenancy on the card
# ---------------------------------------------------------------------------

def _sp_rows(hold, cols: int, n: int) -> list:
    """The first ``n`` holdout rows as request dicts, each with its
    label (a served row ignores it; the guard's metric gate reads it)."""
    feats = [f"f{j}" for j in range(cols)]
    X = np.stack([np.asarray(hold[f].values[:n]) for f in feats], axis=1)
    y = np.asarray(hold["label"].values[:n], np.float64)
    return [dict(zip(feats, r), label=float(lab))
            for r, lab in zip(X.tolist(), y.tolist())]


def _sp_p1(out: list, pred_name: str) -> list:
    return [o[pred_name]["probability_1"] for o in out]


def _sp_traffic(srv, rows: list, pred_name: str, seq: int,
                big: int) -> dict:
    """``seq`` single-row requests, then ``big`` requests of 64 rows:
    latencies and each answered row's probability, in order."""
    lat1, lat64, scores = [], [], []
    for r in rows[:seq]:
        t0 = time.perf_counter()
        out = srv.score([r])
        lat1.append(time.perf_counter() - t0)
        scores += _sp_p1(out, pred_name)
    for k in range(big):
        t0 = time.perf_counter()
        out = srv.score(rows[64 * k:64 * (k + 1)])
        lat64.append(time.perf_counter() - t0)
        scores += _sp_p1(out, pred_name)
    return {"batch1": _pcts(lat1), "batch64": _pcts(lat64),
            "scores": scores}


def _sp_clean(srv, what: str) -> dict:
    snap = srv.snapshot()
    out = {k: snap[k] for k in ("hostFallbacks", "deviceErrors", "shed")}
    check(out == {"hostFallbacks": 0, "deviceErrors": 0, "shed": 0},
          f"serving_plane: the clean {what} server ended with {out}")
    return out


def _sp_cache(prefix: str) -> dict:
    stats = compile_cache.cache_stats()
    return {k: sum(v for key, v in stats[k].items()
                   if key.startswith(prefix))
            for k in ("compiles", "hits", "aotLoads", "aotMisses")}


def _sp_compare_rows(rows: list) -> list:
    """The rows a fresh replica answers: one 64-row request, then
    SP_REPLICA_SINGLES single rows."""
    return [rows[:64]] + [[r] for r in rows[:SP_REPLICA_SINGLES]]


def aot_child(tmp: str) -> None:
    """A fresh replica in this process: the LR served with
    ``device_programs=True`` over the parent's store; prints one JSON
    line (every bucket's mode, the compile ledger, its scores and its
    cold start from the server's construction to the first score)."""
    with open(os.path.join(tmp, "child_in.json")) as f:
        spec = json.load(f)
    t0 = time.perf_counter()
    srv = ModelServer.from_path(spec["path"], name="replica", max_batch=64,
                                warmup_row=spec["rows"][0],
                                device_programs=True,
                                aot_store=spec["store"])
    srv.start()
    first = srv.score(spec["rows"][:1])
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    try:
        ex = srv._executor_for(srv.registry.get("replica"))
        scores = [_sp_p1(srv.score(req), spec["pred"])
                  for req in _sp_compare_rows(spec["rows"])]
        snap = srv.snapshot()
    finally:
        srv.stop()
    print(json.dumps({"cold_start_s": cold_s,
                      "first": _sp_p1(first, spec["pred"]),
                      "modes": {str(b): m for b, m in
                                snap["aotPrograms"].items()},
                      "seconds": {str(b): s for b, s in
                                  ex.programs.seconds.items()},
                      "cache": _sp_cache("serving.replica."),
                      "scores": scores,
                      "host_fallbacks": snap["hostFallbacks"],
                      "device_errors": snap["deviceErrors"]}), flush=True)


def _sp_graphs(train, rows: list, cols: int, tmp: str) -> Tuple[dict, dict]:
    """Leg a: an LR alone on the slice's columns, served eagerly and with
    a CUDA graph per bucket; a fresh replica loads the store; model_v1
    with graphs."""
    label = FeatureBuilder.RealNN("label").as_response()
    preds = [FeatureBuilder.Real(f"f{j}").as_predictor() for j in range(cols)]
    pred = label.transform_with(OpLogisticRegression(), transmogrify(preds))
    t0 = time.perf_counter()
    model = OpWorkflow().set_result_features(pred).set_input_data(
        train).train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    path = os.path.join(tmp, "lr")
    model.save(path)
    del model
    store_dir = os.path.join(tmp, "aot")
    out = {"rows": len(train), "cols": cols, "train_s": train_s}
    servers = {}
    for mode, kw in (("eager", {}),
                     ("graphs", {"device_programs": True,
                                 "aot_store": AOTStore(store_dir)})):
        name = f"lr_{mode}"
        t0 = time.perf_counter()
        srv = ModelServer.from_path(path, name=name, max_batch=64,
                                    warmup_row=rows[0], failure_threshold=1,
                                    breaker_reset_s=SP_BREAKER_RESET_S, **kw)
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        srv.start()
        warm_s = time.perf_counter() - t0
        entry = srv.registry.get(name)
        before = srv.snapshot()
        cache0 = _sp_cache(f"serving.{name}.")
        ps = srv._executor_for(entry).programs
        replays0 = sum(ps.replays.values()) if ps is not None else 0
        traffic = _sp_traffic(srv, rows, pred.name, SP_SEQ_REQUESTS,
                              SP_BIG_REQUESTS)
        after = srv.snapshot()
        cache1 = _sp_cache(f"serving.{name}.")
        batches = after["batches"] - before["batches"]
        leg = {"load_s": load_s, "host_copy_load_s": entry.host_load_s,
               "warmup_s": warm_s, "batch1": traffic["batch1"],
               "batch64": traffic["batch64"], "batches": batches,
               "compiles_after_warmup": cache1["compiles"]
               - cache0["compiles"],
               "hits_after_warmup": cache1["hits"] - cache0["hits"]}
        if ps is not None:
            leg.update(modes={str(b): m for b, m in ps.modes.items()},
                       seconds={str(b): s for b, s in ps.seconds.items()},
                       replays=sum(ps.replays.values()) - replays0,
                       store=ps.store.stats()["entries"])
            check(set(ps.modes.values()) == {"jit"}
                  and len(ps.modes) == 7,
                  f"serving_plane a: bucket modes {ps.modes}")
            check(leg["compiles_after_warmup"] == 0
                  and leg["hits_after_warmup"] == batches
                  == leg["replays"],
                  f"serving_plane a: after warm-up {leg}")
        leg["clean"] = _sp_clean(srv, name)
        servers[mode] = (srv, traffic["scores"])
        out[mode] = leg
    eager, graphs = servers["eager"][1], servers["graphs"][1]
    diff = np.abs(np.asarray(eager) - np.asarray(graphs))
    out["graphs_bitwise_equal"] = bool(eager == graphs)
    out["graphs_max_abs_diff"] = float(diff.max())
    check(out["graphs_max_abs_diff"] <= 1e-6,
          f"serving_plane a: graph-served scores {out['graphs_max_abs_diff']}"
          f" from the eager server's")
    servers["eager"][0].stop()
    gsrv = servers["graphs"][0]
    compare = [_sp_p1(gsrv.score(req), pred.name)
               for req in _sp_compare_rows(rows)]

    # a fresh replica over the same store, in a child process that runs
    # beside the rest of the phase (its wall and cold start are taken
    # with this process busy on one core of the host's eight)
    with open(os.path.join(tmp, "child_in.json"), "w") as f:
        json.dump({"path": path, "store": store_dir, "pred": pred.name,
                   "rows": rows[:64]}, f)
    child_out = open(os.path.join(tmp, "child.out"), "w")
    child_err = open(os.path.join(tmp, "child.err"), "w")
    child = {"t0": time.perf_counter(), "compare": compare, "tmp": tmp,
             "files": (child_out, child_err),
             "proc": subprocess.Popen(
                 [sys.executable, os.path.abspath(__file__), "--aot-child",
                  tmp], stdout=child_out, stderr=child_err)}

    # the committed model_v1 with graphs
    v1 = os.path.join(REPO, "tests", "fixtures", "model_v1")
    with open(os.path.join(v1 + "_input.csv")) as f:
        v1_rows = [{"label": float(r["label"]), "x": float(r["x"]),
                    "cat": r["cat"]} for r in csv.DictReader(f)]
    expected = np.load(os.path.join(REPO, "tests", "fixtures",
                                    "model_v1_expected.npy"))
    with ModelServer.from_path(v1, name="v1_graphs", max_batch=64,
                               warmup_row=v1_rows[0], device_programs=True
                               ) as vsrv:
        got = vsrv.score(v1_rows)
        vsnap = vsrv.snapshot()
    name = next(iter(got[0]))
    v1_err = float(np.abs(np.asarray(_sp_p1(got, name)) - expected).max())
    out["model_v1"] = {"rows": len(v1_rows), "max_abs_err": v1_err,
                       "modes": sorted(set(vsnap["aotPrograms"].values()))}
    check(v1_err <= 1e-5 and out["model_v1"]["modes"] == ["jit"],
          f"serving_plane a: model_v1 with graphs: {out['model_v1']}")
    return out, {"path": path, "pred": pred, "server": gsrv,
                 "scores": servers["graphs"][1], "child": child}


def _sp_replica(child: dict) -> dict:
    """Wait for the fresh replica (``_sp_graphs``' child) and hold it:
    every bucket "aot", no compile, its scores bitwise the parent's."""
    proc = child["proc"]
    try:
        rc = proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        for f in child["files"]:
            f.close()
    wall = time.perf_counter() - child["t0"]
    with open(os.path.join(child["tmp"], "child.out")) as f:
        lines = [ln for ln in f.read().splitlines() if ln.startswith("{")]
    with open(os.path.join(child["tmp"], "child.err")) as f:
        err = f.read()
    check(rc == 0 and lines, f"serving_plane a: the replica child failed "
          f"(rc {rc}): {err[-2000:]}")
    res = json.loads(lines[-1])
    out = {k: res[k] for k in ("cold_start_s", "modes", "seconds", "cache",
                               "host_fallbacks")}
    out["process_wall_s"] = wall
    out["bitwise_equal"] = res["scores"] == child["compare"]
    check(set(res["modes"].values()) == {"aot"} and len(res["modes"]) == 7
          and res["cache"]["compiles"] == 0,
          f"serving_plane a: the replica's modes {res['modes']}, "
          f"ledger {res['cache']}")
    check(out["bitwise_equal"],
          "serving_plane a: the replica's scores differ from the parent's")
    return out


def _sp_rung(srv, rows: list, pred_name: str, card: list) -> dict:
    """Leg b on one server: its device scoring raises; the host rung
    answers SP_HOST_REQUESTS single rows and 64-row requests within
    SP_HOST_TOL of the card's ``card`` scores (those rows' answers at
    the same request sizes); then the device path heals and a trial batch
    after the breaker's reset closes it."""
    ex = srv._executor_for(srv.registry.get(srv.name))
    good = ex.score_fn

    def boom(_rows):
        raise RuntimeError("injected device failure")

    ex.score_fn = boom
    before = srv.snapshot()
    first = _sp_p1(srv.score(rows[:1]), pred_name)   # the failing batch
    after_first = srv.snapshot()
    health = healthz_doc(srv)[1]
    traffic = _sp_traffic(srv, rows, pred_name, SP_HOST_REQUESTS,
                          SP_HOST_BIG_REQUESTS)
    snap = srv.snapshot()
    ex.score_fn = good
    diff = np.abs(np.asarray(first + traffic["scores"])
                  - np.asarray(card[:1] + card))
    time.sleep(SP_BREAKER_RESET_S + 0.1)
    trial = _sp_p1(srv.score(rows[:1]), pred_name)
    out = {"host_batch1": traffic["batch1"],
           "host_batch64": traffic["batch64"],
           "max_abs_diff": float(diff.max()),
           "host_fallbacks": snap["hostFallbacks"]
           - before["hostFallbacks"],
           "device_errors": snap["deviceErrors"] - before["deviceErrors"],
           "breaker_opens": snap["breakerOpens"] - before["breakerOpens"],
           "reason_after_first": after_first["lastFallbackReason"],
           "breaker_after_first": after_first["breakerState"],
           "last_fallback_reason": snap["lastFallbackReason"],
           "healthz": health["status"],
           "healthz_reason": health["lastFallbackReason"],
           "breaker_after_trial": srv.breaker.state,
           "trial_equal_card": trial == card[:1]}
    check(out["max_abs_diff"] <= SP_HOST_TOL
          and out["host_fallbacks"] == 1 + SP_HOST_REQUESTS
          + SP_HOST_BIG_REQUESTS and out["breaker_opens"] >= 1
          and out["reason_after_first"] == "device_error:RuntimeError"
          and out["breaker_after_first"] == "open"
          and out["healthz"] == "degraded"
          and out["healthz_reason"] == "device_error:RuntimeError",
          f"serving_plane b: {srv.name}'s host rung: {out}")
    check(out["breaker_after_trial"] == "closed" and out["trial_equal_card"],
          f"serving_plane b: {srv.name} did not recover on the card: {out}")
    return out


def _sp_guard(xgb_path: str, xgb_model, lr_path: str, train, rows: list,
              cols: int, rounds: int) -> Tuple[dict, int]:
    """Leg c: the boosted model served with a guard; an accepted
    candidate retrained on the card, a rejected broken one, an accepted
    one rolled back by a bake fault."""
    srv = ModelServer.from_path(xgb_path, name="xgb_guard", max_batch=64,
                                warmup_row=rows[0])
    guard = GuardedSwap(srv.registry, "xgb_guard", gate=SwapGateConfig(
        label_name="label", replay_capacity=SP_REPLAY_ROWS,
        p99_factor=SP_P99_FACTOR))
    srv.with_guard(guard)
    out = {}
    with srv:
        for k in range(SP_REPLAY_ROWS // 64):
            srv.score(rows[64 * k:64 * (k + 1)])
        out["replay_rows"] = len(guard.replay_rows())

        # (i) a candidate retrained on the card with another seed
        label = FeatureBuilder.RealNN("label").as_response()
        preds = [FeatureBuilder.Real(f"f{j}").as_predictor()
                 for j in range(cols)]
        checked = label.transform_with(SanityChecker(max_correlation=0.99),
                                       transmogrify(preds))
        cpred = label.transform_with(OpXGBoostClassifier(
            max_depth=6, num_round=rounds, seed=SP_CANDIDATE_SEED), checked)
        gk.seg_level_hists.launches = 0
        t0 = time.perf_counter()
        cand = OpWorkflow().set_result_features(cpred).set_input_data(
            train).train()
        torch.cuda.synchronize()
        retrain_s = time.perf_counter() - t0
        launches = gk.seg_level_hists.launches
        t0 = time.perf_counter()
        d1 = guard.propose(cand)
        shadow_s = time.perf_counter() - t0
        pinned = srv.registry.pinned("xgb_guard")
        t0 = time.perf_counter()
        k = 0
        chunks = SP_REPLAY_ROWS // 64
        while guard.baking and k < 4 * chunks:
            srv.score(rows[64 * (k % chunks):64 * (k % chunks + 1)])
            k += 1
        bake_s = time.perf_counter() - t0
        out["accepted"] = {
            "retrain_rows": len(train), "retrain_s": retrain_s,
            "seg_hist_launches": launches, "accepted": d1.accepted,
            "reasons": d1.reasons, "checks": d1.checks,
            "version": d1.version,
            "pinned": pinned.version if pinned else None,
            "shadow_s": shadow_s, "bake_s": bake_s, "bake_requests": k,
            "baking_after": guard.baking,
            "current": srv.registry.get("xgb_guard").version}
        check(launches > 0 and d1.accepted and d1.version == 2
              and out["accepted"]["pinned"] == 1
              and not guard.baking and out["accepted"]["current"] == 2,
              f"serving_plane c(i): {out['accepted']}")

        # (ii) a broken candidate: the served LR, coefficients negated
        broken = OpWorkflowModel.load(lr_path)
        lr = find_predictor(broken)
        lr.coef, lr.intercept = -lr.coef, -lr.intercept
        t0 = time.perf_counter()
        d2 = guard.propose(broken)
        out["rejected"] = {"accepted": d2.accepted, "reasons": d2.reasons,
                           "checks": d2.checks,
                           "shadow_s": time.perf_counter() - t0,
                           "current": srv.registry.get("xgb_guard").version}
        check(not d2.accepted and out["rejected"]["current"] == 2
              and any(r.startswith(("pred_distance:", "pred_psi:"))
                      for r in d2.reasons),
              f"serving_plane c(ii): {out['rejected']}")

        # (iii) an accepted candidate with a swap.bake fault armed
        with faults.inject(faults.FaultSpec(point="swap.bake",
                                            action="raise")):
            t0 = time.perf_counter()
            d3 = guard.propose(xgb_model)
            shadow3 = time.perf_counter() - t0
            t0 = time.perf_counter()
            srv.score(rows[:64])   # a probe is due: it raises
            bake3 = time.perf_counter() - t0
        snap = srv.snapshot()
        out["rolled_back"] = {
            "accepted": d3.accepted, "reasons": d3.reasons,
            "checks": d3.checks, "version": d3.version,
            "shadow_s": shadow3, "bake_s": bake3,
            "current": srv.registry.get("xgb_guard").version,
            "rollbacks": snap["rollbacks"],
            "last_rollback_reason": snap["lastRollbackReason"]}
        check(d3.accepted and d3.version == 3
              and out["rolled_back"]["current"] == 2
              and snap["rollbacks"] == 1
              and snap["lastRollbackReason"] == "probe_error:FaultError",
              f"serving_plane c(iii): {out['rolled_back']}")
        out["swaps"] = {k: snap[k] for k in ("swapsAccepted",
                                             "swapsRejected", "hotSwaps")}
        out["clean"] = _sp_clean(srv, "guarded")
    return out, launches


def _sp_tenancy(xgb_path: str, lr_path: str, rows: list, pred: dict,
                own: dict) -> dict:
    """Leg d: gold (the boosted model, weight 3) and bronze (the LR,
    weight 1) behind one weighted-fair dispatcher."""
    mts = MultiTenantServer()
    for name, weight, path in (("gold", 3.0, xgb_path),
                               ("bronze", 1.0, lr_path)):
        mts.add_tenant(TenantConfig(name, weight=weight,
                                    max_batch=SP_TENANT_MAX_BATCH,
                                    max_queue_rows=SP_TENANT_QUEUE_ROWS,
                                    warmup_row=rows[0]), path=path)
    out = {}
    with mts:
        routed = {t: _sp_p1(mts.score(rows[:64], tenant=t), pred[t])
                  for t in ("gold", "bronze")}
        out["routed_max_abs_diff"] = {
            t: float(np.abs(np.asarray(routed[t])
                            - np.asarray(own[t])).max()) for t in routed}
        check(all(v <= 1e-6 for v in out["routed_max_abs_diff"].values()),
              f"serving_plane d: routed scores {out['routed_max_abs_diff']}")

        def flood(tenants) -> dict:
            snap0 = mts.snapshot()["tenants"]
            stop = threading.Event()

            def loop(t):
                while not stop.is_set():
                    mts.submit(rows[:SP_FLOOD_ROWS], tenant=t)
                    time.sleep(0.0005)

            threads = [threading.Thread(target=loop,
                                        args=(tenants[i % len(tenants)],))
                       for i in range(SP_FLOOD_THREADS)]
            for th in threads:
                th.start()
            quiet = [t for t in ("gold", "bronze") if t not in tenants]
            t_end = time.perf_counter() + SP_FLOOD_S
            while time.perf_counter() < t_end:
                if quiet:   # the quiet tenant's own steady requests
                    mts.score(rows[:1], tenant=quiet[0])
                else:
                    time.sleep(0.01)
            # the rows dispatched while both lanes were backlogged: the
            # queues' drain after the flood is not a weighted share
            snap1 = mts.snapshot()["tenants"]
            stop.set()
            for th in threads:
                th.join(timeout=10)
            while any(lane.queue for lane in list(mts._lanes.values())):
                time.sleep(0.01)
            return {t: {"dispatched_rows": snap1[t]["wfq"]["dispatchedRows"]
                        - snap0[t]["wfq"]["dispatchedRows"],
                        "shed": snap1[t]["shed"] - snap0[t]["shed"]}
                    for t in ("gold", "bronze")}

        both = flood(["gold", "bronze"])
        ratio = (both["gold"]["dispatched_rows"]
                 / max(both["bronze"]["dispatched_rows"], 1))
        out["flood"] = {"seconds": SP_FLOOD_S, "threads": SP_FLOOD_THREADS,
                        "tenants": both, "gold_over_bronze": ratio}
        check(SP_WFQ_RATIO[0] <= ratio <= SP_WFQ_RATIO[1],
              f"serving_plane d: dispatched rows gold/bronze {ratio}")
        one = flood(["bronze"])
        out["bronze_floods"] = one
        check(one["gold"]["shed"] == 0 and one["bronze"]["shed"] > 0,
              f"serving_plane d: with bronze flooding: {one}")

        bronze = mts.tenant("bronze")
        ex = bronze._executor_for(bronze.registry.get("bronze"))
        good = ex.score_fn

        def boom(_rows):
            raise RuntimeError("injected device failure")

        snap0 = mts.snapshot()["tenants"]
        ex.score_fn = boom
        try:
            for r in rows[:4]:
                mts.score([r], tenant="bronze")
                mts.score([r], tenant="gold")
        finally:
            ex.score_fn = good
        snap1 = mts.snapshot()["tenants"]
        out["fault"] = {t: snap1[t]["hostFallbacks"]
                        - snap0[t]["hostFallbacks"]
                        for t in ("gold", "bronze")}
        check(out["fault"]["bronze"] > 0 and out["fault"]["gold"] == 0,
              f"serving_plane d: host fallbacks {out['fault']}")

        from urllib.request import urlopen

        httpd = make_http_server(mts, "127.0.0.1", 0)
        th = threading.Thread(target=httpd.serve_forever, daemon=True)
        th.start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            with urlopen(base + "/metrics?format=prometheus",
                         timeout=60) as resp:
                prom = obs.parse_exposition(resp.read().decode())
            with urlopen(base + "/tenants", timeout=60) as resp:
                listed = [t["name"] for t in json.loads(resp.read())[
                    "tenants"]]
        finally:
            httpd.shutdown()
            httpd.server_close()
            th.join(timeout=10)
        snap = mts.snapshot()["tenants"]
        out["prometheus_requests"] = {
            t: prom[f'tmog_serving_requests_total{{tenant="{t}"}}']
            for t in ("gold", "bronze")}
        out["tenants_listed"] = listed
        check(all(out["prometheus_requests"][t] == snap[t]["requests"]
                  for t in ("gold", "bronze"))
              and listed == ["bronze", "gold"],
              f"serving_plane d: Prometheus/tenants over HTTP: {out}")
    return out


def phase_serving_plane(data, xgb: dict, cols: int, rounds: int) -> dict:
    """Per-bucket CUDA graphs with a persisted program store (and a fresh
    replica), the host rung, the guarded swap and tenancy, at the slice's
    width on the card."""
    phase_t0 = time.perf_counter()
    tmp = os.path.join(REPO, "smoke_out", "serving_plane")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    train, hold, _ = _rows_cut(data, MODEL_DEPTH_CUT)
    rows = _sp_rows(xgb["hold"], cols, max(SP_REPLAY_ROWS,
                                           64 * SP_BIG_REQUESTS,
                                           SP_SEQ_REQUESTS))
    lr = None
    try:
        leg_a, lr = _sp_graphs(train, rows, cols, tmp)
        xgb_path = os.path.join(tmp, "xgb")
        xgb["model"].save(xgb_path)
        gsrv = lr["server"]
        try:
            card = (lr["scores"][:SP_HOST_REQUESTS]
                    + lr["scores"][SP_SEQ_REQUESTS:SP_SEQ_REQUESTS
                                   + 64 * SP_HOST_BIG_REQUESTS])
            leg_b = {"lr": _sp_rung(gsrv, rows, lr["pred"].name, card)}
        finally:
            gsrv.stop()
        xname = xgb["pred"].name
        xsrv = ModelServer.from_path(xgb_path, name="xgb_rung", max_batch=64,
                                     warmup_row=rows[0], failure_threshold=1,
                                     breaker_reset_s=SP_BREAKER_RESET_S)
        with xsrv:
            card = _sp_traffic(xsrv, rows, xname, SP_HOST_REQUESTS,
                               SP_HOST_BIG_REQUESTS)["scores"]
            leg_b["xgb"] = _sp_rung(xsrv, rows, xname, card)
            leg_b["xgb"]["host_copy_load_s"] = xsrv.registry.get(
                "xgb_rung").host_load_s
        leg_c, launches = _sp_guard(xgb_path, xgb["model"], lr["path"],
                                    train, rows, cols, rounds)
        leg_d = _sp_tenancy(
            xgb_path, lr["path"], rows,
            {"gold": xname, "bronze": lr["pred"].name},
            {"gold": card[SP_HOST_REQUESTS:SP_HOST_REQUESTS + 64],
             "bronze": lr["scores"][SP_SEQ_REQUESTS:SP_SEQ_REQUESTS + 64]})
        leg_a["replica"] = _sp_replica(lr.pop("child"))
    finally:
        if lr is not None and "child" in lr:   # a leg failed: stop it
            lr["child"]["proc"].kill()
            lr["child"]["proc"].wait()
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"phase": "serving_plane", "a": leg_a, "b": leg_b, "c": leg_c,
           "d": leg_d, "seg_hist_launches": launches,
           "phase_s": time.perf_counter() - phase_t0,
           "predicted": SERVING_PLANE_PREDICTED}
    emit(out)
    return out


def phase_profile(dev, rows: int, cols: int, rounds: int) -> None:
    """One XGBoost fit of ``rounds`` rounds at the slice's width under
    torch.profiler, on data drawn on the card by the same recipe: for the
    binning and the boosting range of ``fit_raw``, the wall, the card's
    busy time (kernels, copies, memsets) and idle share, and the boosting's
    heaviest device ops per round."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=dev).manual_seed(11)
    X = torch.randn(rows, cols, generator=gen, device=dev)
    beta = torch.zeros(cols, device=dev)
    informative = torch.randperm(cols, generator=gen, device=dev)[
        :max(3, cols // 20)]
    beta[informative] = 1.5 * torch.randn(len(informative), generator=gen,
                                          device=dev)
    z = X @ beta + 0.5 * torch.randn(rows, generator=gen, device=dev)
    y = (torch.sigmoid(z) > torch.rand(rows, generator=gen, device=dev))
    y = y.to(torch.float32).cpu().numpy()
    est = OpXGBoostClassifier(max_depth=6, num_round=rounds)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        est.fit_raw(X, y, device=dev)
        torch.cuda.synchronize()
    events = prof.events()
    ranges = {e.name: e.time_range for e in events
              if e.name in ("tmog.binning", "tmog.boosting")
              and e.device_type == DeviceType.CPU}
    # the ranges also show on the card's timeline, as annotations
    dev_evs = [e for e in events if e.device_type == DeviceType.CUDA
               and e.name not in ranges]
    out = {"phase": "profile", "rows": rows, "cols": cols, "max_depth": 6,
           "rounds": est.metadata["rounds_grown"]}
    for key, tr in ranges.items():
        inside = [e for e in dev_evs if tr.start <= e.time_range.start
                  and e.time_range.end <= tr.end]
        busy_us = sum(e.time_range.elapsed_us() for e in inside)
        wall_us = tr.elapsed_us()
        part = key.split(".")[1]
        out[part] = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
                     "device_idle_share": 1 - busy_us / wall_us}
        if part == "boosting":
            by_name = {}
            for e in inside:
                t, c = by_name.get(e.name[:60], (0.0, 0))
                by_name[e.name[:60]] = (t + e.time_range.elapsed_us(), c + 1)
            top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
            n = out["rounds"]
            out[part]["top_device_ops_per_round"] = [
                {"name": k, "ms": t / 1e3 / n, "count": c / n}
                for k, (t, c) in top]
    emit(out)
    check(len(dev_evs) > 0 and set(ranges) == {"tmog.binning",
                                                "tmog.boosting"},
          "profile: no device events or missing fit ranges")


def _profiled(fn) -> dict:
    """Wall, the card's busy time and idle share, and the heaviest device
    ops of one call of ``fn`` under torch.profiler (CPU and CUDA)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    by_name = {}
    for e in dev:
        t, c = by_name.get(e.name[:60], (0.0, 0))
        by_name[e.name[:60]] = (t + e.time_range.elapsed_us() / 1e3, c + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms,
            "device_ops": len(dev),
            "top_device_ops": [{"name": k, "ms": t, "count": c}
                               for k, (t, c) in top]}


def phase_regression_profile(dev, rows: int, cols: int) -> None:
    """Where the regression sweep's tree growth spends its time: under
    torch.profiler, one base pair's forest of 4 trees (depth 12, min
    instances 10, one-third feature subsets, bag mode "bagged") and one
    boosted chain's 3 rounds (depth 12, full width), on data drawn on
    the card with the regression phase's label scale.  Per level: the
    wall, the card's busy time and idle share."""
    gen = torch.Generator(device=dev).manual_seed(REG_SEED)
    X = torch.randn(rows, cols, generator=gen, device=dev)
    y = (22.5 + 7 * X[:, 0] + 4 * torch.tanh(X[:, 1] * X[:, 2])
         + 3 * torch.randn(rows, generator=gen, device=dev))
    binned = gk.apply_bins(X, gk.quantile_bins(X, 32))
    del X
    w = torch.ones((1, rows), device=dev)
    kw = dict(seed=1, n_trees=4, pair_fold=[0], pair_min_ig=[0.001],
              pair_min_inst=[10], pair_depth=[12], msub=cols // 3,
              subsample_rate=1.0, n_bins=32, regression=True)
    gk.grow_rf_grid(binned, y, w, **{**kw, "n_trees": 1})   # warm-up
    grown = {}
    rf = _profiled(lambda: grown.setdefault(
        "rf", gk.grow_rf_grid(binned, y, w, **kw)))
    rf["levels"] = grown["rf"].levels
    rf["wall_ms_per_level"] = rf["wall_ms"] / rf["levels"]

    def chain():
        F = torch.full((rows,), 22.5, device=dev)
        for _ in range(3):
            G, H = F - y, torch.ones_like(F)
            tree = gk.grow_tree(binned, G[:, None], H[:, None], 12, 32,
                                lam=1.0, min_child_weight=1.0,
                                learning_rate=0.1)
            F = F + gk.predict_tree(binned, *tree, 12)[:, 0]

    chain()                                                 # warm-up
    gbt = _profiled(chain)
    gbt["levels"] = 36
    gbt["wall_ms_per_level"] = gbt["wall_ms"] / 36
    out = {"phase": "regression_profile", "rows": rows, "cols": cols,
           "rf_forest": rf, "gbt_chain": gbt}
    emit(out)
    check(rf["device_ops"] > 0 and gbt["device_ops"] > 0,
          "regression_profile: no device events")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--holdout", type=int, default=100_000)
    ap.add_argument("--cols", type=int, default=500)
    ap.add_argument("--rounds", type=int, default=FULL_ROUNDS)
    ap.add_argument("--reps", type=int, default=10)
    # the out_of_core phase runs each leg-a train in a child of its own
    ap.add_argument("--ooc-child", choices=["in_core", "chunked"],
                    help=argparse.SUPPRESS)
    ap.add_argument("--ooc-train", help=argparse.SUPPRESS)
    ap.add_argument("--ooc-holdout", help=argparse.SUPPRESS)
    ap.add_argument("--ooc-chunk-rows", type=int, help=argparse.SUPPRESS)
    # the events phase runs each leg-a train in a child of its own
    ap.add_argument("--events-child", choices=["in_core", "streamed"],
                    help=argparse.SUPPRESS)
    ap.add_argument("--events-train", help=argparse.SUPPRESS)
    ap.add_argument("--events-holdout", help=argparse.SUPPRESS)
    ap.add_argument("--events-chunk-rows", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--events-out", help=argparse.SUPPRESS)
    # the selector_options phase's leg b runs a sweep in a child it kills
    ap.add_argument("--sweep-child", help=argparse.SUPPRESS)
    # the out_of_core phase's leg d runs a checkpointed train in a child
    # it kills
    ap.add_argument("--ckpt-child", help=argparse.SUPPRESS)
    # the obs phase runs its two trains in a child
    ap.add_argument("--obs-child", help=argparse.SUPPRESS)
    # the serving_plane phase's fresh replica
    ap.add_argument("--aot-child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke needs one",
              file=sys.stderr)
        return 1
    if args.ooc_child:
        torch.backends.cuda.matmul.allow_tf32 = False
        ooc_child(args.ooc_train, args.ooc_holdout, args.ooc_child,
                  args.ooc_chunk_rows)
        return 0
    if args.sweep_child:
        torch.backends.cuda.matmul.allow_tf32 = False
        sweep_child(args.sweep_child, args.cols)
        return 0
    if args.ckpt_child:
        torch.backends.cuda.matmul.allow_tf32 = False
        ckpt_child(args.ooc_train, args.ooc_holdout, args.ckpt_child)
        return 0
    if args.obs_child:
        torch.backends.cuda.matmul.allow_tf32 = False
        obs_child(args.obs_child, args.cols)
        return 0
    if args.aot_child:
        torch.backends.cuda.matmul.allow_tf32 = False
        aot_child(args.aot_child)
        return 0
    if args.events_child:
        torch.backends.cuda.matmul.allow_tf32 = False
        events_child(args.events_train, args.events_holdout,
                     args.events_child, args.events_chunk_rows,
                     args.events_out)
        return 0
    faulthandler.dump_traceback_later(STACKS_AT_S, exit=False)
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    if name != CARD:
        raise RuntimeError(f"no published peak rates for {name!r}: the "
                           f"bounds are computed for {CARD}")
    bw, f32 = PEAK_BYTES_PER_S, PEAK_F32_OPS_PER_S
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # aggregate shared-memory rate: SMs x 128 bytes a clock (32 banks of 4
    # bytes) x the SM clock nvidia-smi reports as its maximum
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(_smi("clocks.max.sm").split()[0])
    smem_bw = sms * 128 * mhz * 1e6
    emit({"phase": "device", "name": name, "bytes_per_s": bw,
          "f32_ops_per_s": f32, "smem_bytes_per_s": smem_bw,
          "smem_rate_from": f"{sms} SMs x 128 B/clock x {mhz:g} MHz "
                            f"(nvidia-smi clocks.max.sm)",
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # the slice's data is drawn on a host thread while nvcc builds the
    # kernel (the build waits on a subprocess; numpy's draws drop the GIL)
    with ThreadPoolExecutor(1) as pool:
        made = pool.submit(make_datasets, args.rows, args.holdout, args.cols)
        phase_build()
        phase_tree(dev)
        data = made.result()
    torch.cuda.empty_cache()
    sl, xgb = phase_slice(data, args.cols, args.rounds)
    torch.cuda.empty_cache()
    sel, lr = phase_selector(data, args.cols)
    torch.cuda.empty_cache()
    obs_line, obs_cli = phase_obs(data, args.cols)
    torch.cuda.empty_cache()
    options, _ = phase_selector_options(data, sel["holdout_aupr"], args.cols,
                                        args.reps, bw, f32)
    finish_obs_cli(obs_cli)
    torch.cuda.empty_cache()
    reg = phase_regression(_rows_cut(data, MODEL_DEPTH_CUT), args.cols)
    torch.cuda.empty_cache()
    tdata = titanic_data(args.rows, args.holdout)
    titanic = phase_titanic(_depth_cut(tdata, TITANIC_DEPTH_CUT), args.reps,
                            bw, f32, smem_bw)
    torch.cuda.empty_cache()
    validate = phase_validate_explain(_depth_cut(tdata, VE_DEPTH_CUT), data,
                                      xgb, args.cols)
    torch.cuda.empty_cache()
    feature_eng = phase_feature_eng(_depth_cut(tdata, FE_DEPTH_CUT),
                                    args.reps, bw, f32)
    del tdata
    torch.cuda.empty_cache()
    avro = phase_avro_combined(data, sel["holdout_aupr"], args.reps, bw, f32,
                               rows=args.rows // AVRO_DEPTH_CUT,
                               holdout=args.holdout // AVRO_DEPTH_CUT)
    torch.cuda.empty_cache()
    ooc = phase_out_of_core(args.rows // OOC_DEPTH_CUT,
                            args.holdout // OOC_DEPTH_CUT, args.reps, bw, f32)
    torch.cuda.empty_cache()
    events = phase_events(args.reps, bw, f32)
    torch.cuda.empty_cache()
    app = phase_app()
    torch.cuda.empty_cache()
    model_data = _rows_cut(data, MODEL_DEPTH_CUT)
    multi, mc = phase_multiclass(model_data, args.cols, args.reps, bw, f32)
    torch.cuda.empty_cache()
    boosted = phase_boosted_multi(mc, model_data, args.cols, args.reps, bw,
                                  f32, smem_bw)
    del model_data
    del mc
    torch.cuda.empty_cache()
    phase_glm_isotonic(data, xgb)
    torch.cuda.empty_cache()
    wide = phase_xgb_wide(args.rows // WIDE_DEPTH_CUT,
                          args.holdout // WIDE_DEPTH_CUT, args.reps, bw,
                          f32, smem_bw)
    torch.cuda.empty_cache()
    phase_iris(args.rows, args.holdout)
    torch.cuda.empty_cache()
    served, request_rows = phase_serve([xgb, lr], args.cols)
    torch.cuda.empty_cache()
    plane = phase_serving_plane(data, xgb, args.cols, args.rounds)
    del xgb, lr, data
    torch.cuda.empty_cache()
    seg = phase_seg_hist(dev, args.rows, args.cols, reg["checked_cols"],
                         args.reps, bw, f32, smem_bw)
    torch.cuda.empty_cache()
    phase_seg_hist_channels(dev, args.rows, args.reps, bw, f32, smem_bw)
    torch.cuda.empty_cache()
    phase_profile(dev, args.rows, args.cols, PROFILE_ROUNDS)
    torch.cuda.empty_cache()
    phase_regression_profile(dev, args.rows, args.cols)
    torch.cuda.empty_cache()
    phase_serve_profile(served, request_rows[:PROFILE_REQUESTS])

    # per-launch means over the six level shapes of a depth-6 round
    levels = [r for r in seg if r["in_mean"]]

    def mean(key):
        return statistics.fmean(r[key] for r in levels)

    emit({"phase": "seg_hist_summary", "over": "M = 1..32, d=500",
          "ms": mean("kernel_ms"), "layout_ms": mean("layout_ms"),
          "kernel_only_ms": mean("kernel_only_ms"),
          "groups_ms": mean("groups_ms"), "reduce_ms": mean("reduce_ms"),
          "bound_ms": mean("bound_ms"),
          "smem_floor_ms": mean("smem_floor_ms"),
          "worst_tol_ratio": max(r["tol_ratio"] for r in seg),
          "worst_ms": max(r["kernel_ms"] for r in levels)})
    emit({"phase": "seg_hist_two_channel",
          "xgb_ms_mean": mean("kernel_ms"),
          "xgb_ms_earlier": EARLIER_XGB_MS,
          "rf_ms": {r["M"]: r["kernel_ms"] for r in seg
                    if r["path"] == "rf"},
          "rf_ms_earlier": EARLIER_RF_MS})
    emit({"kernels": [{
        "name": "seg_hist", "route": "cuda", "source": SEG_HIST_SOURCE,
        "replaces": SEG_HIST_REPLACES,
        "launches": (sl["seg_hist_launches"] + sel["seg_hist_launches"]
                     + obs_line["seg_hist_launches"]
                     + options["seg_hist_launches"]
                     + reg["seg_hist_launches_total"]
                     + titanic["seg_hist_launches"]
                     + titanic["efb_launches"]
                     + validate["launches_total"]
                     + feature_eng["seg_hist_launches"]
                     + avro["seg_hist_launches"]
                     + ooc["seg_hist_launches"]
                     + ooc["refresh_cv_launches"]
                     + events["seg_hist_launches"]
                     + app["seg_hist_launches"]
                     + multi["seg_hist_launches"]
                     + boosted["launches_total"]
                     + wide["launches_total"]
                     + plane["seg_hist_launches"]),
        "max_abs_err": max(r["max_abs_err"] for r in seg),
        "ms": mean("kernel_ms"), "plain_ms": mean("plain_ms"),
        "bound_ms": mean("bound_ms"), "bound_by": levels[-1]["bound_by"],
        "library_ms": mean("library_ms")}]})
    emit({"phase": "smoke_total", "s": time.perf_counter() - _T0,
          "previous_s": SMOKE_PREVIOUS_S,
          "predicted_s": SMOKE_PREDICTED["smoke_s"],
          "predicted_slow_host_s": SMOKE_PREDICTED["smoke_slow_host_s"]})
    print(_smi("name,power.limit"), flush=True)
    faulthandler.cancel_dump_traceback_later()
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
