"""Speculation round: configs, sampling, rejection, signals, policies, drafters."""
