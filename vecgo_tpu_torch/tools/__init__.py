"""Operational CLI tools (offline writer-process jobs).

The reference separates writers from stateless read replicas over a shared
store (vecgo.go:151-179, engine.go:380-420); these tools are the writer-side
jobs run out of process: the serving process reopens the new manifest
version.
"""
