"""Refinement drivers."""
