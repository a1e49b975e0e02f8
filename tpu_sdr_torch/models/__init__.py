"""Receive chains of the port."""
