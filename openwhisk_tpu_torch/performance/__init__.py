"""The port's performance harness: the simulations (latency, throughput,
cold, apiv1, soak), owperf, the placement-kernel sweep and warm-hit parity,
each a copy of its counterpart under the repository's `tests/performance/`
run as `python -m openwhisk_tpu_torch.performance.<tool>`."""
