"""Device milliseconds a repeat of the collect phase (``collect_fn``: the
fused collect, its tail and the returns kernel), between the program's
own stamps ``marlnav.collect`` in the graph's last replay of the traced
window (``utils.profiling.phase_ms``).  Nothing where the program has no
phase marks (off the card, switched off, or a program without them)."""


def read(ctx):
    from marlnav_tpu_torch.utils import profiling

    phase_ms = getattr(profiling, "phase_ms", None)
    if phase_ms is None:
        return None
    return phase_ms().get("collect")
