"""Fault tolerance for training (a part of ``repro.distributed``)."""
