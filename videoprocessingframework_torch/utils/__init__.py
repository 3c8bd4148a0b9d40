"""Tracing, device selection and native build helpers."""
