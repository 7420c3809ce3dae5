"""End-to-end validation of the port: the JAX project's ``experiments/``
(``semantic_validation.py``, ``privacy_leakage.py``) on PyTorch and the card.

    python -m ccst_tpu_torch.experiments.semantic_validation [--quick] [--seeds 1,2,3,4,5]
    python -m ccst_tpu_torch.experiments.privacy_leakage [--quick]

Both chain the port's stages (encoder pretraining, decoder training, style
banks, calibration, stylization, list generation, federated training, the
inverter) on the synthetic ``shapes4`` benchmark and write a JSON artifact,
by default under ``ccst_tpu_torch/experiments/results/``. ``--device``
defaults to ``cuda``; ``--device cpu`` runs them on the CPU.
"""
