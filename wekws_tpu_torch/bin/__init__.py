"""Command-line entry points: ``python -m wekws_tpu_torch.bin.<name>``.

Each module parses its arguments only inside ``main(argv=None)``, so
importing one (tests, spawned loader workers) runs nothing.
"""
