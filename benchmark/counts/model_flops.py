"""Model FLOPs of the networks as the reference defines them, whatever
route computes them (recomputation not counted).  A Linear costs 2 in out
a row forward and three times that forward and backward.

  actor : F -> H -> 2 + 2 (no hidden activation)
  critic: A F -> H -> 1

A training repeat of P envs x T steps with E_a actor and E_c critic
epochs: the actor's forward on P T A rows in the collect, its forward and
backward on P T A rows an actor epoch, the critic's forward and backward
on P T rows a critic epoch, and its forward on P (T + 1) rows for the
values.  A rollout env-step: the actor's forward on A rows."""


def actor_forward_per_row(obs: int, hidden: int, actions: int = 2) -> int:
    return 2 * (obs * hidden + hidden * 2 * actions)


def critic_forward_per_row(n_in: int, hidden: int) -> int:
    return 2 * (n_in * hidden + hidden)


def train_repeat(envs: int, steps: int, agents: int, obs: int, hidden: int,
                 actor_epochs: int, critic_epochs: int) -> int:
    actor_rows = envs * steps * agents
    fa = actor_forward_per_row(obs, hidden)
    fc = critic_forward_per_row(agents * obs, hidden)
    return (actor_rows * fa + actor_epochs * 3 * actor_rows * fa
            + critic_epochs * 3 * envs * steps * fc
            + envs * (steps + 1) * fc)


def rollout_env_step(agents: int, obs: int, hidden: int) -> int:
    return agents * actor_forward_per_row(obs, hidden)
