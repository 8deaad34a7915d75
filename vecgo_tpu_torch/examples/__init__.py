"""The JAX package's examples (examples/*.py) against vecgo_tpu_torch.

Each module has `main(device="cuda")` and runs as a script:

    python -m vecgo_tpu_torch.examples.basic
    python -c "from vecgo_tpu_torch.examples import basic; basic.main('cpu')"
"""
