"""The port's distributed pieces (JAX counterpart
deeplearning4j_tpu/distributed): so far only the replica-scoped half of
the fault-spec grammar (`faults.py`) that the serving fleet's chaos
hooks read. The multi-process runtime — bootstrap, launcher, elastic
recovery and the process-scoped faults — waits for ROADMAP Queue A
item A7.
"""
