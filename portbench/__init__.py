"""The benchmark of the PyTorch and CUDA port (``fuzzy_aho_corasick_tpu_torch``).

``python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once. Nothing here imports JAX or the JAX
package; the plain reference (``reference.py``) imports nothing of the port.
"""
