"""The plain reference that decides ``correct``: the channel, the code's
layered schedule and the fixed-point layered min-sum decoder, in plain
PyTorch and NumPy.  It imports nothing of ``ldpcgputegra_tpu_torch``,
``ldpcgputegra_tpu`` or jax, and takes nothing the program made: it reads
the raw matrix files and works out every table itself.
"""
