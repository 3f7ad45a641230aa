"""Training: AdamW, the train step and topology-free checkpoints (a port of
``repro.training``)."""
