"""Utilities of the port (JAX counterpart deeplearning4j_tpu/util):
`checkpoint.py`, the port's own checkpoint format.
"""
