"""The benchmark of ``deepfluids_tpu_torch`` on NVIDIA H100 cards.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once (see
:mod:`benchmark.run`); ``python3 -m benchmark.calibrate`` reads the
numbers the limits of ``correct`` are set from.  Nothing here imports JAX
or the JAX package, and the references import nothing of the measured
program.
"""
