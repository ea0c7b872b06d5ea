"""EasyRider core: PDU (filter + ESS + controller), battery health, fleet
engines, grid compliance and the software-burn baseline, in PyTorch."""
