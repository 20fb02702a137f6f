"""The curriculum programs: ``python -m marlnav_tpu_torch.scripts.<name>``.

Counterparts of the programs beside the JAX package (``scripts/``), with
the same flags, schedules, printed JSON lines and files, plus
``--device`` (default ``cuda``; ``--device cpu`` runs the kernels' plain
PyTorch versions).  Their default ``--out`` lies under ``runs/``.

  curriculum.py         staged geometry and the adaptive target-radius
                        curricula, one continuing policy; resumes the JAX
                        programs' state pickles (``utils/jax_state.py``)
  render_curriculum.py  replays a saved actor and counts the envs whose
                        agents reach the target disk together
  sweep.py              the reward-factor grid through ``train.train``
"""
