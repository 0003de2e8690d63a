"""Entry points of the port beside the run: the measurements on the card
(microbenchmarks, probes, trace summaries), the scene assets, and the
evaluation tools (the protocol runner, completion gaps)."""
