"""EasyRider core: PDU (filter + ESS + controller), battery health, fleet
engines and grid compliance, in PyTorch."""
