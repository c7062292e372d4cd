"""Device busy time (the union of its kernels, copies and sets) in the traced
blocks, a step. Beside the untraced ``train_steps_per_s`` it gives the idle
share without the profiler's own cost between kernels: 1 − this ×
steps/s ÷ 10⁶."""


def read(r):
    if not r.steps or r.view.busy_us <= 0:
        return None
    return r.view.busy_us / r.steps
