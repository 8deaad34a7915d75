"""Lexical search of the port: the exact host BM25 index (`bm25`) and its
device serving snapshot (`device_bm25`), which sweeps the hot-term weight
table with `scan_topk_columns`."""
