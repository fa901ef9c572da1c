"""Splitting a jet batch over several devices."""
