"""``loss_and_grads_ms`` (ms): the mean CUDA-event time of the step's
calls of ``runtime.trainer.loss_and_grads`` (the model's forward, its
recomputation and backward) in the traced window."""


def read(rec):
    calls = rec.spans.get("loss_and_grads") if rec.trace is not None else None
    if not calls or not rec.trace.device:
        return None
    return 1e3 * sum(calls) / len(calls)
