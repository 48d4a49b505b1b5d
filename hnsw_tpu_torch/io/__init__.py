"""Synthetic data generation."""
