"""The port's tools, one module each, runnable as
``python -m deepfluids_tpu_torch.tools.<name>``.

Counterparts of the repo-root ``tools/*.py`` of the JAX package, under the
same names: ``bench_suite`` (seven timed surfaces), ``eval_run``,
``rollout_eval``, ``latent_predictability``, ``solver_consistency``,
``regen_all``, ``weights_io``, ``make_goldens`` and ``supervise``.  Each runs
on the CUDA card unless ``--device cpu`` is given, raises without a card
otherwise, and appends its record to ``--out`` (:mod:`._record`), never to
the JAX package's ``BENCHMARKS.jsonl``.
"""
