"""Segment indexes of the port: flat and Vamana (graph) segments."""
