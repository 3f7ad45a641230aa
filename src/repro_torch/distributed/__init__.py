"""Fault tolerance for training and gradient compression (a part of
``repro.distributed``)."""
