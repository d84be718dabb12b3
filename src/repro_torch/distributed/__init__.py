"""Multi-host coordination (``collective``), the partition rules and
leading-axis layouts (``sharding``), GPipe (``pipeline``) and the
point-to-point ops it stages through host memory (``exchange``) of the
port."""
