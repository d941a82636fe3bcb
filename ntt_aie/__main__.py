from ntt_aie.cli import main

import sys

sys.exit(main())
