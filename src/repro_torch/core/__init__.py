"""The MAIZX core of the port: accounting, ranking, placement, simulator."""
