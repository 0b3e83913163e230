"""Examples of the port that are also entry points
(``python -m repro_torch.examples.<name>``).  Importing one does no work."""
