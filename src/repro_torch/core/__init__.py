"""Engines and host-side method fitting of the port."""
