"""Multilevel preconditioner: host levels and the device solve."""
