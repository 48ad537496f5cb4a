"""Environment layer of the PyTorch port: the Action type, the cloth
simulator and env, the task oracles and the closed-loop evaluators.

The port's counterpart of bifold_tpu/env/ (``action``, ``native``, ``sim``,
``garments``, ``cloth_env``, ``demonstrators``, ``cache_builder``,
``softgym_evaluator``, ``bimanual_evaluator``, ``scenes``,
``pyflex_compat``, ``xml_model``). The simulator is host code (numpy and
C++); the evaluators' policies run the model on the card. Heavy
submodules import lazily: ``from bifold_tpu_torch.env import Action`` pulls
in nothing else."""

from bifold_tpu_torch.env.action import DUMMY_PICK, Action

__all__ = ["Action", "DUMMY_PICK"]
