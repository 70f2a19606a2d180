"""The benchmark of the PyTorch and CUDA port (``simpledsp_tpu_torch``).

``python3 -m dspbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell; ``README.md`` says how a later change adds a
configuration, a traffic mix or a metric as new files.  Importing this
package imports neither torch nor the port.
"""
