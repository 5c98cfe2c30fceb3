"""The benchmark of ``qrec_tpu_torch``, the PyTorch and CUDA port, on
NVIDIA cards: ``python3 portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` (see ``run.py``).

Nothing here imports JAX or the JAX package; :mod:`portbench.system` is
the one module that imports the port, and :mod:`portbench.reference`
imports neither.
"""
