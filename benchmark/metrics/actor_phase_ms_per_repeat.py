"""Device milliseconds a repeat of the actor phase (``train_actor``: the
advantages' staging, then at every step the affine operator's
recomposition, the gradient kernel and Adam), between the program's own
stamps ``marlnav.actor`` in the graph's last replay of the traced window
(``utils.profiling.phase_ms``).  Nothing where the program has no phase
marks (off the card, switched off, or a program without them)."""


def read(ctx):
    from marlnav_tpu_torch.utils import profiling

    phase_ms = getattr(profiling, "phase_ms", None)
    if phase_ms is None:
        return None
    return phase_ms().get("actor")
