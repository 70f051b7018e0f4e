"""Offline tools: the weight bridge from the JAX package, data-list
building (wav durations, ``make_list``, ``shuffle_list``), blob stores
(``make_blob``), global CMVN statistics, kernel timing scripts, and the
serving SLOs, decode-drift sweep and knob convergence gates
(``bench_serving_slo``, ``drift_sweep``, ``gate_knobs``).

``compute_cmvn_stats`` is exported as in the JAX package, imported on
first use so that the list tools start without torch."""


def __getattr__(name):
    if name == "compute_cmvn_stats":
        from wekws_tpu_torch.tools.cmvn_stats import compute_cmvn_stats

        return compute_cmvn_stats
    raise AttributeError(name)


__all__ = ["compute_cmvn_stats"]
