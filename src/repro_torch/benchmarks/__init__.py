"""Scripts for the paper's tables on the port (``benchmarks/`` of the JAX
package): ``python -m repro_torch.benchmarks.table2_comm_storage`` and
``python -m repro_torch.benchmarks.table5_tradeoff``."""
