"""Command-line interface of the port (JAX counterpart
deeplearning4j_tpu/cli; reference: deeplearning4j-cli —
driver/CommandLineInterfaceDriver.java, subcommands/{Train, Test,
Predict}.java with args4j flags -conf/-input/-output/-model/-type)."""

from .driver import main

__all__ = ["main"]
