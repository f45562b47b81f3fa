"""Roofline terms of a step, counted on the ``meta`` device (``roofline``)."""
