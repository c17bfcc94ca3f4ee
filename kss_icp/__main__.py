import sys

from kss_icp.cli import main

sys.exit(main())
