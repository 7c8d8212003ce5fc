"""Serving engine, scheduler, requests."""
