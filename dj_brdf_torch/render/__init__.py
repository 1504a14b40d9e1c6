"""Rendering: sphere shading, renderer materials, the path tracer."""
